// EBCOT Tier-1 + MQ coder fast path (C API for ctypes).
//
// Exact semantic mirror of entropy/ebcot.py + entropy/mq.py (which are the
// behavioral reference, pinned by tests/test_native.py equivalence tests):
// ISO/IEC 15444-1 Annex C MQ coder with OpenJPEG byteout/flush/bypass
// semantics and Annex D stripe-ordered SPP/MRP/CP passes with the full
// code-block style matrix (LAZY/RESET/TERMALL/VSC*/PTERM/SEGSYM).
//
// Build: g++ -O3 -shared -fPIC -o libebcot.so ebcot_native.cpp

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>

// Gather bit `bp_` from 32 consecutive uint32 magnitude|sign cells into
// one MSB-first 32-bit word (the raw-MRP bulk encoder's bit pattern).
// Shifting the target bit to lane position 31 pushes the sign MSB out,
// so no magnitude mask is needed; one movemask covers 8 samples.
static inline uint32_t gather_plane_bits32(const uint32_t* c, int bp_) {
  const __m256i rev = _mm256_setr_epi32(7, 6, 5, 4, 3, 2, 1, 0);
  const __m128i sh = _mm_cvtsi32_si128(31 - bp_);
  uint32_t v = 0;
  for (int q = 0; q < 4; q++) {
    __m256i x = _mm256_loadu_si256((const __m256i*)(c + 8 * q));
    x = _mm256_permutevar8x32_epi32(x, rev);
    x = _mm256_sll_epi32(x, sh);
    v = (v << 8) | (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(x));
  }
  return v;
}

// Scatter a 32-bit MSB-first refinement word onto 32 consecutive uint32
// magnitude|sign cells: the vector mirror of the raw-MRP bulk decoder's
// recon_ref (exact form cur + bit<<bp; ojp mid-bin form
// (mag - 2^bp + bit*2^(bp+1)) | sign — see t1_decode_impl).
static inline void scatter_ref_bits32(uint32_t* c, int bp_, uint32_t v,
                                      bool ojp) {
  const __m128i cnt_bp = _mm_cvtsi32_si128(bp_);
  const __m128i cnt_bp1 = _mm_cvtsi32_si128(bp_ + 1);
  const __m256i one = _mm256_set1_epi32(1);
  const __m256i msb = _mm256_set1_epi32((int)0x80000000u);
  const __m256i vv = _mm256_set1_epi32((int)v);
  __m256i sh = _mm256_setr_epi32(31, 30, 29, 28, 27, 26, 25, 24);
  const __m256i eight = _mm256_set1_epi32(8);
  for (int q = 0; q < 4; q++) {
    __m256i bits = _mm256_and_si256(_mm256_srlv_epi32(vv, sh), one);
    __m256i cur = _mm256_loadu_si256((const __m256i*)(c + 8 * q));
    __m256i out;
    if (!ojp) {
      out = _mm256_add_epi32(cur, _mm256_sll_epi32(bits, cnt_bp));
    } else {
      __m256i mag = _mm256_andnot_si256(msb, cur);
      mag = _mm256_sub_epi32(mag, _mm256_sll_epi32(one, cnt_bp));
      mag = _mm256_add_epi32(mag, _mm256_sll_epi32(bits, cnt_bp1));
      out = _mm256_or_si256(mag, _mm256_and_si256(cur, msb));
    }
    _mm256_storeu_si256((__m256i*)(c + 8 * q), out);
    sh = _mm256_sub_epi32(sh, eight);
  }
}
#endif

namespace {

// ---- MQ tables (ISO Table C.2) ---------------------------------------------
const uint32_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12,
                          13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                          25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
                          37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18,
                          20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
                          22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
                          34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH_[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// Packed next-state tables indexed by the full ctx byte (state | mps<<7):
// PNMPS folds the MPS-path transition, PNLPS folds NLPS + the SWITCH
// sense flip — one load replaces state unpack + switch logic on the
// encode hot path (byte-for-byte the same transitions).
struct MQPackedTables {
  uint8_t pnmps[256], pnlps[256];
  MQPackedTables() {
    for (int st = 0; st < 47; st++)
      for (int mps = 0; mps < 2; mps++) {
        int s = st | (mps << 7);
        pnmps[s] = (uint8_t)(NMPS[st] | (mps << 7));
        int nm = SWITCH_[st] ? 1 - mps : mps;
        pnlps[s] = (uint8_t)(NLPS[st] | (nm << 7));
      }
  }
};
const MQPackedTables MQPT;

// context indices
const int CTX_RL = 17, CTX_UNI = 18, NUMCTX = 19;

// style flags
const int S_LAZY = 0x01, S_RESET = 0x02, S_TERMALL = 0x04, S_VSC = 0x08,
          S_PTERM = 0x10, S_SEGSYM = 0x20;

// column-flags word layout (one uint32 per stripe-column; the OpenJPEG
// "column flags" idea — reference behavior anchor t1/encoder.go:159-282,
// implemented here from the T.800 rules, not transcribed):
//   sigma of the 3x6 window, (row j in -1..4, col c in 0..2): bit 3*(j+1)+c
//   pi  (coded in SPP)  row j in 0..3: bit 18+j
//   mu  (refined once)  row j in 0..3: bit 22+j
//   chi (sign, own col) row j in -1..4: bit 26+(j+1)
// Whole-column skip tests replace the per-sample flag loads, and the
// 9-bit ZC neighborhood is a single shift of the word.
const uint32_t SIG18 = 0x3FFFFu;                 // all sigma bits
const uint32_t PI4 = 0xFu << 18;                 // all pi bits
const uint32_t MU4 = 0xFu << 22;                 // all mu bits
const uint32_t SIGMA_MID4 = (1u << 4) | (1u << 7) | (1u << 10) | (1u << 13);
const uint32_t SIG_ROW4 = 7u << 15;              // stripe-below row

// ---- context LUTs (generated from T.800 D.1/D.3 rules like ebcot.py) -------
uint8_t ZC_LUT[4][512];
// 6-bit row mask -> every-3rd-bit spread (rows -1..4 of one column to
// its slot in the 18-bit window layout above); the T1N engine composes
// whole window words from per-column sigma masks with three lookups.
uint32_t SPREAD3[64];
uint8_t SC_LUT[256];
uint8_t SPB_LUT[256];
bool luts_ready = false;

int zc_context(int h, int v, int d, int orient) {
  if (orient == 1) { int t = h; h = v; v = t; }
  if (orient != 3) {
    if (h == 2) return 8;
    if (h == 1) { if (v >= 1) return 7; return d >= 1 ? 6 : 5; }
    if (v == 2) return 4;
    if (v == 1) return 3;
    return d >= 2 ? 2 : (d == 1 ? 1 : 0);
  }
  int hv = h + v;
  if (d >= 3) return 8;
  if (d == 2) return hv >= 1 ? 7 : 6;
  if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
  return hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
}

// one-time LUT fill, thread-safe: the per-codeblock pool can enter the
// coders concurrently and the old `if (ready) return; ...; ready=true`
// pattern raced (caught by the round-5 TSAN lane — idempotent writes,
// so byte parity never noticed, but UB regardless)
std::once_flag luts_once;
void build_luts_impl() {
  for (int orient = 0; orient < 4; orient++)
    for (int idx = 0; idx < 512; idx++) {
      int nw = idx & 1, n = (idx >> 1) & 1, ne = (idx >> 2) & 1;
      int w = (idx >> 3) & 1, e = (idx >> 5) & 1;
      int sw = (idx >> 6) & 1, s = (idx >> 7) & 1, se = (idx >> 8) & 1;
      ZC_LUT[orient][idx] =
          (uint8_t)zc_context(w + e, n + s, nw + ne + sw + se, orient);
    }
  for (int v = 0; v < 64; v++) {
    uint32_t s = 0;
    for (int r = 0; r < 6; r++)
      if (v & (1 << r)) s |= 1u << (3 * r);
    SPREAD3[v] = s;
  }
  // sign coding (T.800 Table D.3)
  const int tbl[3][3][2] = {  // [hc+1][vc+1] -> {ctx, spb}
      {{13, 1}, {12, 1}, {11, 1}},
      {{10, 1}, {9, 0}, {10, 0}},
      {{11, 0}, {12, 0}, {13, 0}}};
  for (int idx = 0; idx < 256; idx++) {
    auto contrib = [](int sig, int neg) { return !sig ? 0 : (neg ? -1 : 1); };
    int w = contrib((idx >> 3) & 1, idx & 1);
    int e = contrib((idx >> 5) & 1, (idx >> 2) & 1);
    int n = contrib((idx >> 1) & 1, (idx >> 4) & 1);
    int s = contrib((idx >> 7) & 1, (idx >> 6) & 1);
    int hc = w + e; if (hc > 1) hc = 1; if (hc < -1) hc = -1;
    int vc = n + s; if (vc > 1) vc = 1; if (vc < -1) vc = -1;
    // table above is indexed [hc+1][vc+1] with the mapping:
    // (1,1)=13/0 (1,0)=12/0 (1,-1)=11/0 (0,1)=10/0 (0,0)=9/0 (0,-1)=10/1
    // (-1,1)=11/1 (-1,0)=12/1 (-1,-1)=13/1
    int ctx, spb;
    if (hc == 1)      { ctx = vc == 1 ? 13 : (vc == 0 ? 12 : 11); spb = 0; }
    else if (hc == 0) { ctx = vc == 0 ? 9 : 10; spb = vc == -1 ? 1 : 0; }
    else              { ctx = vc == 1 ? 11 : (vc == 0 ? 12 : 13); spb = 1; }
    SC_LUT[idx] = (uint8_t)ctx;
    SPB_LUT[idx] = (uint8_t)spb;
    (void)tbl;
  }
  luts_ready = true;
}
void build_luts() { std::call_once(luts_once, build_luts_impl); }

// 9-bit neighborhood window for row j: bits [NW N NE W own E SW S SE] at
// positions 0..8 — exactly the ZC_LUT index layout (the LUT ignores
// bit 4, the own-sigma slot). VSC: stripe-bottom rows (j==3) see the
// stripe below as insignificant.
inline uint32_t nb9(uint32_t f, int j, bool vsc) {
  uint32_t g = (f >> (3 * j)) & 0x1FFu;
  if (vsc && j == 3) g &= 0x3Fu;
  return g;
}

// own-column sigma bits (3*j+4 for j=0..3) compacted to a nibble — the
// pass loops iterate set bits with ctz instead of testing all four j's
// (the per-j branches are ~50% mispredicts at the active planes)
inline uint32_t sig_nibble(uint32_t f) {
#if defined(__BMI2__) && defined(__AVX2__)
  return _pext_u32(f, 0x2490u);
#else
  return ((f >> 4) & 1) | ((f >> 6) & 2) | ((f >> 8) & 4) |
         ((f >> 10) & 8);
#endif
}

// SC/SPB LUT index (same bit assignments the LUTs were generated for)
// from the own word f and the left/right neighbor columns' words.
inline int sc_index_cf(uint32_t f, uint32_t fl, uint32_t fr, int j,
                       bool vsc) {
  // branchless: extract each sigma/chi bit and compose the LUT index
  uint32_t w_sig = (f >> (3 * j + 3)) & 1;
  uint32_t n_sig = (f >> (3 * j + 1)) & 1;
  uint32_t e_sig = (f >> (3 * j + 5)) & 1;
  uint32_t s_sig = (vsc && j == 3) ? 0 : ((f >> (3 * j + 7)) & 1);
  uint32_t w_chi = (fl >> (27 + j)) & 1;
  uint32_t n_chi = (f >> (26 + j)) & 1;
  uint32_t e_chi = (fr >> (27 + j)) & 1;
  uint32_t s_chi = (f >> (28 + j)) & 1;
  return (int)((w_sig << 3) | (w_sig & w_chi)
               | (n_sig << 1) | ((n_sig & n_chi) << 4)
               | (e_sig << 5) | ((e_sig & e_chi) << 2)
               | (s_sig << 7) | ((s_sig & s_chi) << 6));
}

// MR context: refined-before -> 16, significant neighborhood -> 15, else 14
inline int mr_context_cf(uint32_t f, int j, bool vsc) {
  if (f & (1u << (22 + j))) return 16;
  if (nb9(f, j, vsc) & 0x1EFu) return 15;
  return 14;
}

// ---- NMSEDEC distortion tables (T.800 J.4; same fixed point as the
//      Python entropy/ebcot.py generator) ------------------------------------
static int nmse_sig[128], nmse_sig0[128], nmse_ref[128], nmse_ref0[128];
static bool nmse_ready = false;
inline int nmse_q(double f) {
  long v = (long)std::floor(f * 64.0 + 0.5);
  return v > 0 ? (int)(v * 128) : 0;
}
std::once_flag nmse_once;
void build_nmse_impl() {
  for (int i = 0; i < 128; i++) {
    double t = i / 64.0;
    nmse_sig[i] = nmse_q(3.0 * t - 2.25);
    nmse_sig0[i] = nmse_q(t * t);
    nmse_ref[i] = nmse_q(t < 1.0 ? 0.75 - t : t - 1.25);
    nmse_ref0[i] = nmse_q((t - 1.0) * (t - 1.0));
  }
  nmse_ready = true;
}
void build_nmse() { std::call_once(nmse_once, build_nmse_impl); }
inline int nmsedec_sig(uint64_t av, int bp) {
  uint64_t x = av << 6;
  if (bp > 0) return nmse_sig[(x >> bp) & 127];
  return nmse_sig0[x & 127];
}
inline int nmsedec_ref(uint64_t av, int bp) {
  uint64_t x = av << 6;
  if (bp > 0) return nmse_ref[(x >> bp) & 127];
  return nmse_ref0[x & 127];
}

// ---- MQ encoder -------------------------------------------------------------
struct MQEnc {
  std::vector<uint8_t> buf;
  int bp = 0;
  uint32_t a = 0x8000, c = 0;
  int ct = 12;
  uint8_t ctx[NUMCTX] = {0};

  MQEnc() { buf.resize(1, 0); }

  // geometric growth: byteout() runs ~1 per coded byte, so a +1 resize
  // there costs an _M_fill_insert per byte (gprof: 2.1M calls/frame)
  void ensure(int idx) {
    if ((int)buf.size() <= idx)
      buf.resize(std::max((size_t)idx + 1, buf.size() * 2), 0);
  }
  void reserve_hint(size_t n) { if (buf.size() < n) buf.resize(n, 0); }

  void byteout() {
    ensure(bp);
    if (buf[bp] == 0xFF) {
      bp++; ensure(bp);
      buf[bp] = (c >> 20) & 0xFF; c &= 0xFFFFF; ct = 7; return;
    }
    if ((c & 0x8000000) == 0) {
      bp++; ensure(bp);
      buf[bp] = (c >> 19) & 0xFF; c &= 0x7FFFF; ct = 8; return;
    }
    buf[bp]++;
    if (buf[bp] == 0xFF) {
      c &= 0x7FFFFFF; bp++; ensure(bp);
      buf[bp] = (c >> 20) & 0xFF; c &= 0xFFFFF; ct = 7; return;
    }
    bp++; ensure(bp);
    buf[bp] = (c >> 19) & 0xFF; c &= 0x7FFFF; ct = 8;
  }

  void renorme() {
    // clz form: one bulk shift instead of a mispredicted per-bit loop;
    // a >= 0x8000 makes this a no-op, so encode() calls it
    // unconditionally (a >= 1 always: a >= qe after the exchange rules)
    int sh = __builtin_clz(a) - 16;
    while (sh >= ct) {
      a <<= ct;
      c <<= ct;
      sh -= ct;
      ct = 0;
      byteout();  // resets ct to 7 or 8
    }
    a <<= sh;
    c <<= sh;
    ct -= sh;
  }

  // encode with the context byte held in a caller register — removes
  // the per-symbol ctx[] store->load forward from the critical path in
  // runs that reuse one context (MRP steady state).
  inline void encode_s(int bit, uint8_t& s) {
    uint32_t qe = QE[s & 0x7F];
    uint32_t lps = (uint32_t)bit ^ (s >> 7);
    a -= qe;
    uint32_t nr = (uint32_t)(lps == 0) & (a >> 15);
    uint32_t lt = a < qe;
    uint32_t addq = lps ? lt : (nr | (lt ^ 1));
    c += addq ? qe : 0;
    uint32_t seta = lps ? (lt ^ 1) : ((nr ^ 1) & lt);
    a = seta ? qe : a;
    uint8_t nst = lps ? MQPT.pnlps[s] : MQPT.pnmps[s];
    s = nr ? s : nst;
    renorme();
  }

  void encode(int bit, int cx) {
    // fully branchless flowchart (byte-identical transitions): random
    // data makes every data-dependent branch here a ~50% mispredict,
    // so all decisions are selects and renorme() self-no-ops.
    uint8_t s = ctx[cx];
    uint32_t qe = QE[s & 0x7F];
    uint32_t lps = (uint32_t)bit ^ (s >> 7);
    a -= qe;
    uint32_t nr = (uint32_t)(lps == 0) & (a >> 15);  // MPS, no renorm
    uint32_t lt = a < qe;                    // shared exchange compare
    // c += qe when: MPS && (no-renorm || !lt); LPS && lt
    uint32_t addq = lps ? lt : (nr | (lt ^ 1));
    c += addq ? qe : 0;
    // a = qe when: MPS-renorm && lt; LPS && !lt
    uint32_t seta = lps ? (lt ^ 1) : ((nr ^ 1) & lt);
    a = seta ? qe : a;
    uint8_t nst = lps ? MQPT.pnlps[s] : MQPT.pnmps[s];
    ctx[cx] = nr ? s : nst;
    renorme();
  }

  void setbits() {
    uint32_t tmp = c + a;
    c |= 0xFFFF;
    if (c >= tmp) c -= 0x8000;
  }

  void flush() {
    setbits();
    c <<= ct; byteout();
    c <<= ct; byteout();
    ensure(bp);
    if (buf[bp] != 0xFF) bp++;
  }

  void erterm() {
    int k = 11 - ct + 1;
    while (k > 0) { c <<= ct; ct = 0; byteout(); k -= ct; }
    ensure(bp);
    if (buf[bp] != 0xFF) byteout();
  }

  void restart_init() {
    a = 0x8000; c = 0; ct = 12;
    if (bp > 0) bp--;
    ensure(bp);
    if (buf[bp] == 0xFF) ct = 13;
  }

  // bypass
  int raw_ct = -1;
  void bypass_init() { c = 0; raw_ct = -1; }
  void bypass_encode(int bit) {
    if (raw_ct == -1) raw_ct = 8;
    raw_ct--;
    c += (uint32_t)bit << raw_ct;
    if (raw_ct == 0) {
      ensure(bp);
      buf[bp] = c & 0xFF;
      raw_ct = (buf[bp] == 0xFF) ? 7 : 8;
      bp++; c = 0;
    }
  }
  // batched bypass: append the low n bits of `bits` (MSB-first),
  // byte-identical to n bypass_encode() calls — the per-bit version
  // is a mispredicted-branch hotspot in lazy dense low planes
  inline void bypass_encode_n(uint32_t bits, int n) {
    if (raw_ct == -1) raw_ct = 8;
    while (n > 0) {
      int take = raw_ct < n ? raw_ct : n;
      raw_ct -= take;
      n -= take;
      c += ((bits >> n) & ((1u << take) - 1)) << raw_ct;
      if (raw_ct == 0) {
        ensure(bp);
        buf[bp] = c & 0xFF;
        raw_ct = (buf[bp] == 0xFF) ? 7 : 8;
        bp++; c = 0;
      }
    }
  }
  void bypass_flush(bool ert) {
    if (raw_ct == -1) return;  // no raw bits written
    int ct2 = raw_ct;
    if (ct2 < 7 || (ct2 == 7 && (ert || (bp > 0 && buf[bp - 1] != 0xFF)))) {
      int bit = 0;
      while (ct2 > 0) { ct2--; c += (uint32_t)bit << ct2; bit = 1 - bit; }
      ensure(bp);
      buf[bp] = c & 0xFF; bp++;
    } else if (ct2 == 7 && bp > 0 && buf[bp - 1] == 0xFF) {
      if (!ert) bp--;
    } else if (ct2 == 8 && !ert && bp > 1 && buf[bp - 1] == 0x7F &&
               buf[bp - 2] == 0xFF) {
      bp -= 2;
    }
    raw_ct = ct2;
  }
  int num_bytes() const { return bp > 1 ? bp - 1 : 0; }
};

// ---- MQ decoder --------------------------------------------------------------
struct MQDec {
  const uint8_t* data;
  int datalen, bp = 0;
  uint32_t a = 0x8000, c = 0;
  int ct = 0;
  uint8_t ctx[NUMCTX] = {0};
  uint8_t sentinel[2] = {0xFF, 0xFF};
  std::vector<uint8_t> owned;

  void init(const uint8_t* d, int n, const uint8_t* inherit) {
    owned.assign(d, d + n);
    owned.push_back(0xFF); owned.push_back(0xFF);
    data = owned.data(); datalen = n; bp = 0; a = 0x8000; c = 0; ct = 0;
    if (inherit) memcpy(ctx, inherit, NUMCTX);
    else memset(ctx, 0, NUMCTX);
    c = (datalen == 0 ? 0xFFu : (uint32_t)data[0]) << 16;
    bytein();
    c <<= 7; ct -= 7; a = 0x8000;
  }

  void bytein() {
    uint8_t nxt = data[bp + 1];
    if (data[bp] == 0xFF) {
      if (nxt > 0x8F) { c += 0xFF00; ct = 8; }
      else { bp++; c += (uint32_t)nxt << 9; ct = 7; }
    } else { bp++; c += (uint32_t)nxt << 8; ct = 8; }
  }

  void renormd() {
    // clz form: bulk-shift between byteins; no-op when a >= 0x8000, so
    // decode() calls it unconditionally
    int sh = __builtin_clz(a) - 16;
    while (sh) {
      if (ct == 0) bytein();
      int step = sh < ct ? sh : ct;
      a <<= step;
      c <<= step;
      ct -= step;
      sh -= step;
    }
  }

  int decode(int cx) {
    // fully branchless (byte-identical decisions): packed next-state
    // tables + selects; see MQEnc::encode for the rationale.
    uint8_t s = ctx[cx];
    uint32_t mps = s >> 7;
    uint32_t qe = QE[s & 0x7F];
    a -= qe;
    uint32_t cold = (c >> 16) < qe;          // LPS-side of the interval
    c -= cold ? 0 : (qe << 16);
    uint32_t nr = (cold ^ 1) & (a >> 15);    // no renorm, no exchange
    uint32_t lt = a < qe;
    uint32_t flip = cold ^ lt;               // decision differs from MPS
    int d = (int)(mps ^ (nr ? 0 : flip));
    uint8_t nst = flip ? MQPT.pnlps[s] : MQPT.pnmps[s];
    ctx[cx] = nr ? s : nst;
    a = cold ? qe : a;
    renormd();
    return d;
  }

  // decode with the context byte held in a caller register — the
  // decode-side mirror of MQEnc::encode_s (MRP steady-state runs)
  inline int decode_s(uint8_t& s) {
    uint32_t mps = s >> 7;
    uint32_t qe = QE[s & 0x7F];
    a -= qe;
    uint32_t cold = (c >> 16) < qe;
    c -= cold ? 0 : (qe << 16);
    uint32_t nr = (cold ^ 1) & (a >> 15);
    uint32_t lt = a < qe;
    uint32_t flip = cold ^ lt;
    int d = (int)(mps ^ (nr ? 0 : flip));
    uint8_t nst = flip ? MQPT.pnlps[s] : MQPT.pnmps[s];
    s = nr ? s : nst;
    a = cold ? qe : a;
    renormd();
    return d;
  }
};

struct RawDec {
  std::vector<uint8_t> owned;
  const uint8_t* data;
  int bp = 0;
  uint32_t c = 0;
  int ct = 0;
  void init(const uint8_t* d, int n) {
    owned.assign(d, d + n);
    owned.push_back(0xFF); owned.push_back(0xFF);
    data = owned.data(); bp = 0; c = 0; ct = 0;
  }
  int decode() {
    if (ct == 0) {
      if (c == 0xFF) {
        uint8_t nxt = data[bp];
        if (nxt > 0x8F) { c = 0xFF; ct = 8; }
        else { c = nxt; bp++; ct = 7; }
      } else { c = data[bp]; bp++; ct = 8; }
    }
    ct--;
    return (c >> ct) & 1;
  }
  // batched mirror of decode(): n bits MSB-first, identical stream
  // position afterwards
  inline uint32_t decode_n(int n) {
    uint32_t v = 0;
    while (n > 0) {
      if (ct == 0) {
        if (c == 0xFF) {
          uint8_t nxt = data[bp];
          if (nxt > 0x8F) { c = 0xFF; ct = 8; }
          else { c = nxt; bp++; ct = 7; }
        } else { c = data[bp]; bp++; ct = 8; }
      }
      int take = ct < n ? ct : n;
      ct -= take;
      n -= take;
      v = (v << take) | ((c >> ct) & ((1u << take) - 1));
    }
    return v;
  }
};

// ---- pass helpers -------------------------------------------------------------
inline bool lazy_raw(int bp_, int maxbp, int pt, int style) {
  if (!(style & S_LAZY) || pt >= 2) return false;
  return bp_ < maxbp - 3;
}
inline bool terminating(int bp_, int maxbp, int pt, int style) {
  if (pt == 2 && bp_ == 0) return true;
  if (style & S_TERMALL) return true;
  if (style & S_LAZY) {
    if (bp_ == maxbp - 3 && pt == 2) return true;
    if (bp_ < maxbp - 3 && pt > 0) return true;
  }
  return false;
}

// MT is the magnitude word: uint32_t when every |coefficient| fits 30
// bits (the common case — keeps the whole block's data L1-resident),
// uint64_t for deep-ROI / extreme-depth blocks. Samples are stored as
// magnitude | (sign << MSB).
template <typename MT>
struct T1CF {
  static constexpr int MSBIT = sizeof(MT) * 8 - 1;
  static constexpr MT MSB = (MT)1 << MSBIT;
  static constexpr MT MAGMASK = MSB - 1;

  int w, h, nstripes, fstride;
  std::vector<uint32_t> F;   // (nstripes + 2) x (w + 2), padded
  std::vector<MT> dataS;     // stripe-column packed: [st][x][4 rows]

  T1CF(int w_, int h_) : w(w_), h(h_) {
    nstripes = (h + 3) / 4;
    fstride = w + 2;
    F.assign((size_t)(nstripes + 2) * fstride, 0);
    dataS.assign((size_t)nstripes * w * 4, 0);
  }
  inline uint32_t* fw(int st) {  // row pointer, indexed by x in [-1, w]
    return F.data() + (size_t)(st + 1) * fstride + 1;
  }
  inline MT* col(int st, int x) {
    return dataS.data() + ((size_t)st * w + x) * 4;
  }

  // Sample (x, stripe st, row j) became significant with the given sign:
  // set own sigma/chi and the window bits of the left/right columns and,
  // at stripe edges, of the adjacent stripes' words.
  inline void set_sig(int st, int x, int j, int sign) {
    uint32_t* p = fw(st) + x;
    p[0] |= 1u << (3 * (j + 1) + 1);
    p[-1] |= 1u << (3 * (j + 1) + 2);
    p[1] |= 1u << (3 * (j + 1));
    if (sign) p[0] |= 1u << (27 + j);
    if (j == 0) {
      uint32_t* u = fw(st - 1) + x;
      u[0] |= 1u << 16; u[-1] |= 1u << 17; u[1] |= 1u << 15;
      if (sign) u[0] |= 1u << 31;
    } else if (j == 3) {
      uint32_t* d = fw(st + 1) + x;
      d[0] |= 1u << 1; d[-1] |= 1u << 2; d[1] |= 1u << 0;
      if (sign) d[0] |= 1u << 26;
    }
  }

  // set_sig with the own column's word held in a caller register: the
  // pass loops keep `f` live, and routing the own-word bits through
  // memory (store, |=, reload) puts a store->load forward on the
  // critical path of every significance event. Neighbor words still
  // go through memory (they must: the scan reads them fresh).
  inline void set_sig_f(int st, int x, int j, int sign, uint32_t& f) {
    uint32_t* p = fw(st) + x;
    f |= 1u << (3 * (j + 1) + 1);
    p[-1] |= 1u << (3 * (j + 1) + 2);
    p[1] |= 1u << (3 * (j + 1));
    if (sign) f |= 1u << (27 + j);
    if (j == 0) {
      uint32_t* u = fw(st - 1) + x;
      u[0] |= 1u << 16; u[-1] |= 1u << 17; u[1] |= 1u << 15;
      if (sign) u[0] |= 1u << 31;
    } else if (j == 3) {
      uint32_t* d = fw(st + 1) + x;
      d[0] |= 1u << 1; d[-1] |= 1u << 2; d[1] |= 1u << 0;
      if (sign) d[0] |= 1u << 26;
    }
  }
};

// Encode one code-block (templated pass engine; see T1CF). VSC is a
// compile-time flag so the stripe-boundary masking branches vanish in
// the (overwhelmingly common) non-VSC instantiation.
template <typename MT, bool VSC, bool NM, typename ST>
int t1_encode_impl(const ST* src, int w, int h, int style, int orient,
                   int roishift, uint8_t* out, int out_cap, int* numbps_out,
                   int* npasses_out, int* pass_rates, uint8_t* pass_terms,
                   int* pass_bitplanes, int* pass_nmsedec, int max_passes) {
  constexpr MT MSB = T1CF<MT>::MSB;
  constexpr MT MAGMASK = T1CF<MT>::MAGMASK;
  constexpr int MSBIT = T1CF<MT>::MSBIT;
  build_luts();
  build_nmse();
  T1CF<MT> t(w, h);
  int nstripes = t.nstripes;
  uint64_t maxabs = 0;
  // repack into stripe-column order as magnitude|sign; per-column OR of
  // magnitudes lets the CP fast path test "no bit at this plane" with
  // one shift
  std::vector<MT> colmag((size_t)nstripes * w, 0);
  for (int st = 0; st < nstripes; st++)
    for (int x = 0; x < w; x++) {
      MT* c = t.col(st, x);
      MT m = 0;
      for (int j = 0; j < 4; j++) {
        int y = st * 4 + j;
        int64_t v = y < h ? (int64_t)src[(size_t)y * w + x] : 0;
        uint64_t av = (uint64_t)(v < 0 ? -v : v);
        c[j] = (MT)av | (v < 0 ? MSB : (MT)0);
        m |= (MT)av;
      }
      colmag[(size_t)st * w + x] = m;
      if ((uint64_t)m > maxabs) maxabs = (uint64_t)m;
    }
  int numbps = 0;
  while (maxabs > 0) { numbps++; maxabs >>= 1; }
  MQEnc mq;
  mq.reserve_hint((size_t)w * h + 512);
  if (numbps == 0) {
    mq.flush();
    *numbps_out = 0; *npasses_out = 0;
    int n = mq.num_bytes();
    if (n > out_cap) return -1;
    memcpy(out, mq.buf.data() + 1, n);
    return n;
  }
  int maxbp = numbps - 1;
  mq.ctx[CTX_UNI] = 46; mq.ctx[CTX_RL] = 3; mq.ctx[0] = 4;
  // stripes whose 16 samples are all significant: SPP codes nothing
  // (every column hits the steady-state skip) and CP's only effect is
  // a redundant PI4 clear (the next plane's SPP start clears all of
  // F), so both passes can skip the whole row scan. Monotone: set at
  // the end of a CP scan, never cleared.
  std::vector<uint8_t> stripe_done((size_t)nstripes, 0);
  // stripes where EVERY column is in the MRP steady state (all 4
  // significant + refined before + untouched this plane): the pass is
  // then 4*w consecutive magnitude bits over contiguous dataS — coded
  // in 32-bit gathers (raw) or one register-cached context run (MQ).
  // Monotone once true: SPP skips such stripes before setting any pi,
  // and significance/mu never decrease.
  std::vector<uint8_t> stripe_refss((size_t)nstripes, 0);

  int pass_type = 2, bitplane = maxbp, pass_idx = 0;
  bool prev_term = false;
  const uint8_t* zc = ZC_LUT[orient];
  constexpr bool vsc = VSC;
  constexpr uint32_t vsig = VSC ? (SIG18 & ~SIG_ROW4) : SIG18;

  while (bitplane >= 0 && pass_idx < max_passes) {
    if (pass_type == 0 || (pass_type == 2 && pass_idx == 0)) {
      for (auto& f : t.F) f &= ~PI4;
      if (roishift > 0 && bitplane >= roishift) {
        pass_type = 0; bitplane--; continue;
      }
    }
    bool raw = lazy_raw(bitplane, maxbp, pass_type, style);
    if (prev_term) {
      if (raw) mq.bypass_init(); else mq.restart_init();
      prev_term = false;
    }

    int64_t nm = 0;
    if (pass_type == 0) {  // SPP
      for (int st = 0; st < nstripes; st++) {
        if (stripe_done[st]) continue;
        int hh = h - st * 4; if (hh > 4) hh = 4;
        uint32_t* Fr = t.fw(st);
        for (int x = 0; x < w; x++) {
          uint32_t f = Fr[x];
          if (!(f & SIG18)) continue;   // no significance in the window
          if (hh == 4 && (f & SIGMA_MID4) == SIGMA_MID4)
            continue;                   // steady state: all 4 significant
          const MT* c = t.col(st, x);
          uint32_t todo = ~sig_nibble(f) & ((1u << hh) - 1);
          while (todo) {                 // not-yet-significant samples
            int j = __builtin_ctz(todo);
            todo &= todo - 1;
            uint32_t g = nb9(f, j, vsc);
            if (!(g & 0x1EFu)) continue;             // no sig neighbor
            MT m = c[j];
            uint64_t av = (uint64_t)(m & MAGMASK);
            int sig = (int)((av >> bitplane) & 1);
            if (raw) mq.bypass_encode(sig);
            else mq.encode(sig, zc[g]);
            f |= 1u << (18 + j);                     // pi: coded in SPP
            if (sig) {
              int sign = (int)(m >> MSBIT);
              if (raw) mq.bypass_encode(sign);
              else {
                int si = sc_index_cf(f, Fr[x - 1], Fr[x + 1], j, vsc);
                mq.encode(sign ^ SPB_LUT[si], SC_LUT[si]);
              }
              t.set_sig_f(st, x, j, sign, f);
              if (NM) nm += nmsedec_sig(av, bitplane);
            }
          }
          Fr[x] = f;
        }
      }
    } else if (pass_type == 1) {  // MRP
      for (int st = 0; st < nstripes; st++) {
        int hh = h - st * 4; if (hh > 4) hh = 4;
        uint32_t* Fr = t.fw(st);
        if (hh == 4 && !stripe_refss[st]) {
          bool all = true;
          for (int x = 0; x < w; x++)
            if ((Fr[x] & (SIGMA_MID4 | PI4 | MU4)) != (SIGMA_MID4 | MU4)) {
              all = false; break;
            }
          stripe_refss[st] = all ? 1 : 0;
        }
        if (stripe_refss[st]) {
          // whole-stripe steady state: 4*w consecutive magnitude bits
          // over contiguous dataS; flags unchanged (mu set, pi stays 0)
          const MT* cb = t.col(st, 0);
          if (raw) {
            int x = 0;
            for (; x + 8 <= w; x += 8) {
              const MT* c = cb + (size_t)4 * x;
              uint32_t v;
#if defined(__AVX2__)
              if constexpr (!NM && sizeof(MT) == 4) {
                v = gather_plane_bits32(c, bitplane);
              } else
#endif
              {
                v = 0;
                for (int k = 0; k < 32; k++) {
                  uint64_t av = (uint64_t)(c[k] & MAGMASK);
                  v = (v << 1) | (uint32_t)((av >> bitplane) & 1);
                  if (NM) nm += nmsedec_ref(av, bitplane);
                }
              }
              mq.bypass_encode_n(v, 32);
            }
            for (; x < w; x++) {
              const MT* c = cb + (size_t)4 * x;
              uint32_t nib = 0;
              for (int j = 0; j < 4; j++) {
                uint64_t av = (uint64_t)(c[j] & MAGMASK);
                nib = (nib << 1) | (uint32_t)((av >> bitplane) & 1);
                if (NM) nm += nmsedec_ref(av, bitplane);
              }
              mq.bypass_encode_n(nib, 4);
            }
          } else {
            uint8_t s16 = mq.ctx[16];
            for (int x = 0; x < w; x++) {
              const MT* c = cb + (size_t)4 * x;
              for (int j = 0; j < 4; j++) {
                uint64_t av = (uint64_t)(c[j] & MAGMASK);
                mq.encode_s((int)((av >> bitplane) & 1), s16);
                if (NM) nm += nmsedec_ref(av, bitplane);
              }
            }
            mq.ctx[16] = s16;
          }
          continue;
        }
        for (int x = 0; x < w; x++) {
          uint32_t f = Fr[x];
          if (!(f & SIGMA_MID4)) continue;  // no significant sample here
          const MT* c = t.col(st, x);
          if (hh == 4 &&
              (f & (SIGMA_MID4 | PI4 | MU4)) == (SIGMA_MID4 | MU4)) {
            // steady state: all 4 significant + refined before + not
            // visited this plane — four magnitude bits with no per-
            // sample flag checks (ctx-16 cached in a register for MQ;
            // raw bits go straight to the bypass writer — in lazy mode
            // raw MRP dominates dense low planes)
            if (raw) {
              uint32_t nib = 0;
              for (int j = 0; j < 4; j++) {
                uint64_t av = (uint64_t)(c[j] & MAGMASK);
                nib = (nib << 1) | (uint32_t)((av >> bitplane) & 1);
                if (NM) nm += nmsedec_ref(av, bitplane);
              }
              mq.bypass_encode_n(nib, 4);
            } else {
              uint8_t s16 = mq.ctx[16];
              for (int j = 0; j < 4; j++) {
                uint64_t av = (uint64_t)(c[j] & MAGMASK);
                mq.encode_s((int)((av >> bitplane) & 1), s16);
                if (NM) nm += nmsedec_ref(av, bitplane);
              }
              mq.ctx[16] = s16;
            }
            continue;
          }
          uint32_t todo = sig_nibble(f) & ~(f >> 18) & ((1u << hh) - 1);
          while (todo) {         // significant and not coded this plane
            int j = __builtin_ctz(todo);
            todo &= todo - 1;
            uint64_t av = (uint64_t)(c[j] & MAGMASK);
            int bit = (int)((av >> bitplane) & 1);
            if (raw) mq.bypass_encode(bit);
            else mq.encode(bit, mr_context_cf(f, j, vsc));
            f |= 1u << (22 + j);            // mu: refined once
            if (NM) nm += nmsedec_ref(av, bitplane);
          }
          Fr[x] = f;
        }
      }
    } else {  // CP
      for (int st = 0; st < nstripes; st++) {
        if (stripe_done[st]) continue;
        int hh = h - st * 4; if (hh > 4) hh = 4;
        bool full = hh == 4;
        uint32_t* Fr = t.fw(st);
        for (int x = 0; x < w; x++) {
          uint32_t f = Fr[x];
          if (full && !(f & (vsig | PI4))) {
            // untouched all-insignificant column: run-length mode
            const uint64_t cm = (uint64_t)colmag[(size_t)st * w + x];
            if (!((cm >> bitplane) & 1)) {
              mq.encode(0, CTX_RL);
              continue;
            }
            const MT* c = t.col(st, x);
            int rl_pos = 0;
            while (!((((uint64_t)(c[rl_pos] & MAGMASK)) >> bitplane) & 1))
              rl_pos++;
            mq.encode(1, CTX_RL);
            mq.encode((rl_pos >> 1) & 1, CTX_UNI);
            mq.encode(rl_pos & 1, CTX_UNI);
            bool partial = true;
            for (int j = rl_pos; j < 4; j++) {
              MT m = c[j];
              uint64_t av = (uint64_t)(m & MAGMASK);
              int sig;
              if (partial) { sig = 1; partial = false; }
              else {
                sig = (int)((av >> bitplane) & 1);
                mq.encode(sig, zc[nb9(f, j, vsc)]);
              }
              if (sig) {
                int sign = (int)(m >> MSBIT);
                int si = sc_index_cf(f, Fr[x - 1], Fr[x + 1], j, vsc);
                mq.encode(sign ^ SPB_LUT[si], SC_LUT[si]);
                t.set_sig_f(st, x, j, sign, f);
                if (NM) nm += nmsedec_sig(av, bitplane);
              }
            }
            Fr[x] = f;
            continue;
          }
          if ((f & SIGMA_MID4) == SIGMA_MID4) {
            Fr[x] = f & ~PI4;  // steady state: nothing left to clean up
            continue;
          }
          // per-sample cleanup
          const MT* c = t.col(st, x);
          uint32_t todo = ~sig_nibble(f) & ~(f >> 18) & ((1u << hh) - 1);
          while (todo) {
            int j = __builtin_ctz(todo);
            todo &= todo - 1;
            MT m = c[j];
            uint64_t av = (uint64_t)(m & MAGMASK);
            int sig = (int)((av >> bitplane) & 1);
            mq.encode(sig, zc[nb9(f, j, vsc)]);
            if (sig) {
              int sign = (int)(m >> MSBIT);
              int si = sc_index_cf(f, Fr[x - 1], Fr[x + 1], j, vsc);
              mq.encode(sign ^ SPB_LUT[si], SC_LUT[si]);
              t.set_sig_f(st, x, j, sign, f);
              if (NM) nm += nmsedec_sig(av, bitplane);
            }
          }
          Fr[x] = f & ~PI4;   // clear visited like the per-sample model
        }
        if (full) {
          bool done = true;
          for (int x = 0; x < w; x++)
            if ((Fr[x] & SIGMA_MID4) != SIGMA_MID4) { done = false; break; }
          stripe_done[st] = done ? 1 : 0;
        }
      }
      if (style & S_SEGSYM) {
        mq.encode(1, CTX_UNI); mq.encode(0, CTX_UNI);
        mq.encode(1, CTX_UNI); mq.encode(0, CTX_UNI);
      }
    }

    bool term = terminating(bitplane, maxbp, pass_type, style);
    if (term) {
      if (raw) mq.bypass_flush(style & S_PTERM);
      else if (style & S_PTERM) mq.erterm();
      else mq.flush();
      prev_term = true;
    }
    pass_rates[pass_idx] = mq.num_bytes();
    pass_terms[pass_idx] = term ? 1 : 0;
    pass_bitplanes[pass_idx] = bitplane;
    pass_nmsedec[pass_idx] = (int)nm;

    if (style & S_RESET) {
      memset(mq.ctx, 0, NUMCTX);
      mq.ctx[CTX_UNI] = 46; mq.ctx[CTX_RL] = 3; mq.ctx[0] = 4;
    }
    pass_idx++;
    if (pass_type == 2) { pass_type = 0; bitplane--; } else pass_type++;
  }

  if (!prev_term) mq.flush();
  int n = mq.num_bytes();
  if (pass_idx > 0) {
    pass_rates[pass_idx - 1] = n;
    pass_terms[pass_idx - 1] = 1;
  }
  *numbps_out = numbps;
  *npasses_out = pass_idx;
  if (n > out_cap) return -1;
  memcpy(out, mq.buf.data() + 1, n);
  return n;
}

// ---- normalized-flag encode engine (T1N) -----------------------------------
// Same pass semantics and byte-identical output as t1_encode_impl, but
// the per-column state is NORMALIZED: one uint16 per stripe-column
// holding only that column's own sigma/chi/pi/mu nibbles. The 3x6
// neighborhood views are composed per stripe into a scratch row before
// each scan and then carried in registers: the left column's
// view rolls forward as a register (it is final when the scan reaches
// column x), the right column's view is the pre-pass scratch value
// (that column has not been visited yet), and cross-stripe rows enter
// through the scratch composition (the stripe above is final for this
// pass, the stripe below still holds the previous pass's state —
// exactly the visit-time semantics of the denormalized engine).
// A significance event updates two REGISTERS (own window + own word)
// instead of 3-6 neighbor words in memory — the store->load web that
// BENCHMARKS.md 4i hypothesized as the SPP/CP serializer is gone
// entirely. MEASURED RESULT (kept as the experiment's record): this is
// 4-5% SLOWER on dense/textured 512^2 content and ~14% slower on
// sparse blocks (the per-stripe compose + per-column window assembly
// costs more than the removed stores ever did), refuting the
// hypothesis: the OOO core absorbs the neighbor-store web for free and
// the serial MQ chain is the whole wall. Byte-identity with the
// default engine is pinned in tests/test_native.py.
//   word bits: 0-3 sigma(rows 0..3) | 4-7 chi | 8-11 pi | 12-15 mu
//   view bits (v6/c6): row r at bit r+1 for r in -1..4
template <typename MT>
struct T1N {
  static constexpr int MSBIT = sizeof(MT) * 8 - 1;
  static constexpr MT MSB = (MT)1 << MSBIT;
  static constexpr MT MAGMASK = MSB - 1;

  int w, h, nstripes, stride;
  std::vector<uint16_t> S;      // (nstripes + 2) x (w + 2), padded
  std::vector<MT> dataS;        // stripe-column packed: [st][x][4 rows]
  std::vector<uint8_t> v6, c6;  // per-stripe composed views, [-1..w]

  T1N(int w_, int h_) : w(w_), h(h_) {
    nstripes = (h + 3) / 4;
    stride = w + 2;
    S.assign((size_t)(nstripes + 2) * stride, 0);
    dataS.assign((size_t)nstripes * w * 4, 0);
    v6.assign((size_t)stride, 0);
    c6.assign((size_t)stride, 0);
  }
  inline uint16_t* row(int st) {  // indexed by x in [-1, w]
    return S.data() + (size_t)(st + 1) * stride + 1;
  }
  inline MT* col(int st, int x) {
    return dataS.data() + ((size_t)st * w + x) * 4;
  }
  // Compose the sigma/chi views for stripe st. Row -1 comes from the
  // stripe above (final for this pass), rows 0..3 from this stripe's
  // pre-pass words, row 4 from the stripe below (previous-pass state).
  // AVX2: 16 columns per iteration (the sweep runs once per stripe per
  // pass, so its cost is on the per-COLUMN critical path).
  inline void compose(int st) {
    const uint16_t* up = row(st) - stride - 1;  // include the left pad
    const uint16_t* cur = row(st) - 1;
    const uint16_t* dn = row(st) + stride - 1;
    uint8_t* vp = v6.data();
    uint8_t* cp = c6.data();
    int n = stride, x = 0;
#if defined(__AVX2__)
    const __m256i m1 = _mm256_set1_epi16(1);
    const __m256i mF = _mm256_set1_epi16(0xF);
    for (; x + 16 <= n; x += 16) {
      __m256i u = _mm256_loadu_si256((const __m256i*)(up + x));
      __m256i c = _mm256_loadu_si256((const __m256i*)(cur + x));
      __m256i d = _mm256_loadu_si256((const __m256i*)(dn + x));
      __m256i v = _mm256_or_si256(
          _mm256_or_si256(
              _mm256_and_si256(_mm256_srli_epi16(u, 3), m1),
              _mm256_slli_epi16(_mm256_and_si256(c, mF), 1)),
          _mm256_slli_epi16(_mm256_and_si256(d, m1), 5));
      __m256i ch = _mm256_or_si256(
          _mm256_or_si256(
              _mm256_and_si256(_mm256_srli_epi16(u, 7), m1),
              _mm256_slli_epi16(
                  _mm256_and_si256(_mm256_srli_epi16(c, 4), mF), 1)),
          _mm256_slli_epi16(
              _mm256_and_si256(_mm256_srli_epi16(d, 4), m1), 5));
      // pack 16-bit values (all <= 0x3F) to bytes, fixing lane order
      __m256i vp8 = _mm256_permute4x64_epi64(
          _mm256_packus_epi16(v, _mm256_setzero_si256()), 0xD8);
      __m256i cp8 = _mm256_permute4x64_epi64(
          _mm256_packus_epi16(ch, _mm256_setzero_si256()), 0xD8);
      _mm_storeu_si128((__m128i*)(vp + x),
                       _mm256_castsi256_si128(vp8));
      _mm_storeu_si128((__m128i*)(cp + x),
                       _mm256_castsi256_si128(cp8));
    }
#endif
    for (; x < n; x++) {
      uint32_t u = up[x], c = cur[x], d = dn[x];
      vp[x] = (uint8_t)(((u >> 3) & 1) | ((c & 0xFu) << 1) |
                        ((d & 1) << 5));
      cp[x] = (uint8_t)(((u >> 7) & 1) | (((c >> 4) & 0xFu) << 1) |
                        (((d >> 4) & 1) << 5));
    }
  }
  // 18-bit window for one column, identical to the denormalized
  // engine's f sigma bits — composed on demand for columns that have
  // coding work, so the scan reads contexts with the SAME two-op nb9
  // slice and ZC_LUT. dl is the left column's this-pass sigma delta.
  static inline uint32_t window(const uint8_t* vv, int x, uint32_t dl) {
    return SPREAD3[vv[x - 1] | dl] | (SPREAD3[vv[x]] << 1) |
           (SPREAD3[vv[x + 1]] << 2);
  }
};

// SC/SPB LUT index from the window word (sigma; same slices as
// sc_index_cf's f) and the chi views (the LUTs are shared).
inline int sc_index_w(uint32_t W, uint32_t c6l, uint32_t c6c,
                      uint32_t c6r, int j, bool vsc) {
  uint32_t w_sig = (W >> (3 * j + 3)) & 1;
  uint32_t n_sig = (W >> (3 * j + 1)) & 1;
  uint32_t e_sig = (W >> (3 * j + 5)) & 1;
  uint32_t s_sig = (vsc && j == 3) ? 0 : ((W >> (3 * j + 7)) & 1);
  uint32_t w_chi = (c6l >> (j + 1)) & 1;
  uint32_t n_chi = (c6c >> j) & 1;
  uint32_t e_chi = (c6r >> (j + 1)) & 1;
  uint32_t s_chi = (c6c >> (j + 2)) & 1;
  return (int)((w_sig << 3) | (w_sig & w_chi)
               | (n_sig << 1) | ((n_sig & n_chi) << 4)
               | (e_sig << 5) | ((e_sig & e_chi) << 2)
               | (s_sig << 7) | ((s_sig & s_chi) << 6));
}

template <typename MT, bool VSC, bool NM, typename ST>
int t1_encode_impl_n(const ST* src, int w, int h, int style, int orient,
                     int roishift, uint8_t* out, int out_cap,
                     int* numbps_out, int* npasses_out, int* pass_rates,
                     uint8_t* pass_terms, int* pass_bitplanes,
                     int* pass_nmsedec, int max_passes) {
  constexpr MT MSB = T1N<MT>::MSB;
  constexpr MT MAGMASK = T1N<MT>::MAGMASK;
  constexpr int MSBIT = T1N<MT>::MSBIT;
  build_luts();
  build_nmse();
  T1N<MT> t(w, h);
  int nstripes = t.nstripes;
  uint64_t maxabs = 0;
  std::vector<MT> colmag((size_t)nstripes * w, 0);
  for (int st = 0; st < nstripes; st++)
    for (int x = 0; x < w; x++) {
      MT* c = t.col(st, x);
      MT m = 0;
      for (int j = 0; j < 4; j++) {
        int y = st * 4 + j;
        int64_t v = y < h ? (int64_t)src[(size_t)y * w + x] : 0;
        uint64_t av = (uint64_t)(v < 0 ? -v : v);
        c[j] = (MT)av | (v < 0 ? MSB : (MT)0);
        m |= (MT)av;
      }
      colmag[(size_t)st * w + x] = m;
      if ((uint64_t)m > maxabs) maxabs = (uint64_t)m;
    }
  int numbps = 0;
  while (maxabs > 0) { numbps++; maxabs >>= 1; }
  MQEnc mq;
  mq.reserve_hint((size_t)w * h + 512);
  if (numbps == 0) {
    mq.flush();
    *numbps_out = 0; *npasses_out = 0;
    int n = mq.num_bytes();
    if (n > out_cap) return -1;
    memcpy(out, mq.buf.data() + 1, n);
    return n;
  }
  int maxbp = numbps - 1;
  mq.ctx[CTX_UNI] = 46; mq.ctx[CTX_RL] = 3; mq.ctx[0] = 4;
  std::vector<uint8_t> stripe_done((size_t)nstripes, 0);
  std::vector<uint8_t> stripe_refss((size_t)nstripes, 0);

  int pass_type = 2, bitplane = maxbp, pass_idx = 0;
  bool prev_term = false;
  const uint8_t* zc = ZC_LUT[orient];
  constexpr bool vsc = VSC;

  while (bitplane >= 0 && pass_idx < max_passes) {
    if (pass_type == 0 || (pass_type == 2 && pass_idx == 0)) {
      for (auto& s : t.S) s &= 0xF0FFu;  // clear pi
      if (roishift > 0 && bitplane >= roishift) {
        pass_type = 0; bitplane--; continue;
      }
    }
    bool raw = lazy_raw(bitplane, maxbp, pass_type, style);
    if (prev_term) {
      if (raw) mq.bypass_init(); else mq.restart_init();
      prev_term = false;
    }

    int64_t nm = 0;
    if (pass_type == 0) {  // SPP
      for (int st = 0; st < nstripes; st++) {
        if (stripe_done[st]) continue;
        int hh = h - st * 4; if (hh > 4) hh = 4;
        uint16_t* Sr = t.row(st);
        t.compose(st);
        const uint8_t* vv = t.v6.data() + 1;
        const uint8_t* cc = t.c6.data() + 1;
        uint32_t dprev = 0;     // this-pass sigma delta of column x-1
        uint32_t c6l = cc[-1];
        for (int x = 0; x < w; x++) {
          // bulk skip: when the left column did not change this pass
          // and the next 9 scratch views are zero, columns x..x+7 have
          // empty windows — SPP codes nothing there, no flags change
          while (x + 8 <= w && !dprev) {
            uint64_t a, b;
            memcpy(&a, vv + x, 8);
            memcpy(&b, vv + x + 1, 8);
            if ((uint64_t)vv[x - 1] | a | b) break;
            x += 8; c6l = 0;
          }
          if (x >= w) break;
          uint32_t vl = vv[x - 1] | dprev;
          if (!(vl | vv[x] | vv[x + 1])) { dprev = 0; c6l = cc[x]; continue; }
          uint32_t word = Sr[x];
          if (hh == 4 && (word & 0xFu) == 0xFu) {
            dprev = 0; c6l = cc[x]; continue;  // steady: all significant
          }
          uint32_t W = t.window(vv, x, dprev);
          const MT* c = t.col(st, x);
          uint32_t c6c = cc[x], c6r = cc[x + 1];
          uint32_t delta = 0;
          uint32_t todo = ~word & ((1u << hh) - 1);
          while (todo) {
            int j = __builtin_ctz(todo);
            todo &= todo - 1;
            uint32_t g = nb9(W, j, vsc);
            if (!(g & 0x1EFu)) continue;             // no sig neighbor
            MT m = c[j];
            uint64_t av = (uint64_t)(m & MAGMASK);
            int sig = (int)((av >> bitplane) & 1);
            if (raw) mq.bypass_encode(sig);
            else mq.encode(sig, zc[g]);
            word |= 1u << (8 + j);                   // pi: coded in SPP
            if (sig) {
              int sign = (int)(m >> MSBIT);
              if (raw) mq.bypass_encode(sign);
              else {
                int si = sc_index_w(W, c6l, c6c, c6r, j, vsc);
                mq.encode(sign ^ SPB_LUT[si], SC_LUT[si]);
              }
              W |= 2u << (3 * (j + 1));
              delta |= 1u << (j + 1);
              word |= 1u << j;
              if (sign) { word |= 1u << (4 + j); c6c |= 1u << (j + 1); }
              if (NM) nm += nmsedec_sig(av, bitplane);
            }
          }
          Sr[x] = (uint16_t)word;
          dprev = delta;
          c6l = c6c;
        }
      }
    } else if (pass_type == 1) {  // MRP
      for (int st = 0; st < nstripes; st++) {
        int hh = h - st * 4; if (hh > 4) hh = 4;
        uint16_t* Sr = t.row(st);
        if (hh == 4 && !stripe_refss[st]) {
          bool all = true;
          for (int x = 0; x < w; x++)
            if ((Sr[x] & 0xFF0Fu) != 0xF00Fu) { all = false; break; }
          stripe_refss[st] = all ? 1 : 0;
        }
        if (stripe_refss[st]) {
          // whole-stripe steady state: 4*w consecutive magnitude bits
          const MT* cb = t.col(st, 0);
          if (raw) {
            int x = 0;
            for (; x + 8 <= w; x += 8) {
              const MT* c = cb + (size_t)4 * x;
              uint32_t v;
#if defined(__AVX2__)
              if constexpr (!NM && sizeof(MT) == 4) {
                v = gather_plane_bits32(c, bitplane);
              } else
#endif
              {
                v = 0;
                for (int k = 0; k < 32; k++) {
                  uint64_t av = (uint64_t)(c[k] & MAGMASK);
                  v = (v << 1) | (uint32_t)((av >> bitplane) & 1);
                  if (NM) nm += nmsedec_ref(av, bitplane);
                }
              }
              mq.bypass_encode_n(v, 32);
            }
            for (; x < w; x++) {
              const MT* c = cb + (size_t)4 * x;
              uint32_t nib = 0;
              for (int j = 0; j < 4; j++) {
                uint64_t av = (uint64_t)(c[j] & MAGMASK);
                nib = (nib << 1) | (uint32_t)((av >> bitplane) & 1);
                if (NM) nm += nmsedec_ref(av, bitplane);
              }
              mq.bypass_encode_n(nib, 4);
            }
          } else {
            uint8_t s16 = mq.ctx[16];
            for (int x = 0; x < w; x++) {
              const MT* c = cb + (size_t)4 * x;
              for (int j = 0; j < 4; j++) {
                uint64_t av = (uint64_t)(c[j] & MAGMASK);
                mq.encode_s((int)((av >> bitplane) & 1), s16);
                if (NM) nm += nmsedec_ref(av, bitplane);
              }
            }
            mq.ctx[16] = s16;
          }
          continue;
        }
        t.compose(st);
        const uint8_t* vv = t.v6.data() + 1;
        for (int x = 0; x < w; x++) {
          // bulk skip: four columns with no significant sample (sigma
          // never changes during MRP, so the scratch windows stay exact)
          while (x + 4 <= w) {
            uint64_t m;
            memcpy(&m, Sr + x, 8);
            if (m & 0x000F000F000F000FULL) break;
            x += 4;
          }
          if (x >= w) break;
          uint32_t word = Sr[x];
          if (!(word & 0xFu)) continue;
          const MT* c = t.col(st, x);
          if (hh == 4 && (word & 0xFF0Fu) == 0xF00Fu) {
            // steady state: all significant + refined + untouched
            if (raw) {
              uint32_t nib = 0;
              for (int j = 0; j < 4; j++) {
                uint64_t av = (uint64_t)(c[j] & MAGMASK);
                nib = (nib << 1) | (uint32_t)((av >> bitplane) & 1);
                if (NM) nm += nmsedec_ref(av, bitplane);
              }
              mq.bypass_encode_n(nib, 4);
            } else {
              uint8_t s16 = mq.ctx[16];
              for (int j = 0; j < 4; j++) {
                uint64_t av = (uint64_t)(c[j] & MAGMASK);
                mq.encode_s((int)((av >> bitplane) & 1), s16);
                if (NM) nm += nmsedec_ref(av, bitplane);
              }
              mq.ctx[16] = s16;
            }
            continue;
          }
          uint32_t W = t.window(vv, x, 0);
          uint32_t todo = (word & ~(word >> 8)) & ((1u << hh) - 1);
          while (todo) {
            int j = __builtin_ctz(todo);
            todo &= todo - 1;
            uint64_t av = (uint64_t)(c[j] & MAGMASK);
            int bit = (int)((av >> bitplane) & 1);
            if (raw) mq.bypass_encode(bit);
            else {
              int ctx;
              if (word & (1u << (12 + j))) ctx = 16;
              else ctx = nb9(W, j, vsc) & 0x1EFu ? 15 : 14;
              mq.encode(bit, ctx);
            }
            word |= 1u << (12 + j);          // mu: refined once
            if (NM) nm += nmsedec_ref(av, bitplane);
          }
          Sr[x] = (uint16_t)word;
        }
      }
    } else {  // CP
      for (int st = 0; st < nstripes; st++) {
        if (stripe_done[st]) continue;
        int hh = h - st * 4; if (hh > 4) hh = 4;
        bool full = hh == 4;
        uint16_t* Sr = t.row(st);
        t.compose(st);
        const uint8_t* vv = t.v6.data() + 1;
        const uint8_t* cc = t.c6.data() + 1;
        uint32_t dprev = 0, c6l = cc[-1];
        constexpr uint32_t vmask6 = VSC ? 0x1Fu : 0x3Fu;
        for (int x = 0; x < w; x++) {
          uint32_t vl = vv[x - 1] | dprev;
          uint32_t vany = (vl | vv[x] | vv[x + 1]) & vmask6;
          uint32_t word = Sr[x];
          if (full && !(vany | (word & 0xF00u))) {
            // untouched all-insignificant column: run-length mode
            const uint64_t cm = (uint64_t)colmag[(size_t)st * w + x];
            if (!((cm >> bitplane) & 1)) {
              mq.encode(0, CTX_RL);
              dprev = 0; c6l = cc[x]; continue;
            }
            const MT* c = t.col(st, x);
            int rl_pos = 0;
            while (!((((uint64_t)(c[rl_pos] & MAGMASK)) >> bitplane) & 1))
              rl_pos++;
            mq.encode(1, CTX_RL);
            mq.encode((rl_pos >> 1) & 1, CTX_UNI);
            mq.encode(rl_pos & 1, CTX_UNI);
            uint32_t W = t.window(vv, x, dprev);
            uint32_t c6c = cc[x], c6r = cc[x + 1];
            uint32_t delta = 0;
            bool partial = true;
            for (int j = rl_pos; j < 4; j++) {
              MT m = c[j];
              uint64_t av = (uint64_t)(m & MAGMASK);
              int sig;
              if (partial) { sig = 1; partial = false; }
              else {
                sig = (int)((av >> bitplane) & 1);
                mq.encode(sig, zc[nb9(W, j, vsc)]);
              }
              if (sig) {
                int sign = (int)(m >> MSBIT);
                int si = sc_index_w(W, c6l, c6c, c6r, j, vsc);
                mq.encode(sign ^ SPB_LUT[si], SC_LUT[si]);
                W |= 2u << (3 * (j + 1));
                delta |= 1u << (j + 1);
                word |= 1u << j;
                if (sign) { word |= 1u << (4 + j); c6c |= 1u << (j + 1); }
                if (NM) nm += nmsedec_sig(av, bitplane);
              }
            }
            Sr[x] = (uint16_t)word;
            dprev = delta;
            c6l = c6c;
            continue;
          }
          if ((word & 0xFu) == 0xFu) {
            Sr[x] = (uint16_t)(word & 0xF0FFu);  // steady: clear pi
            dprev = 0; c6l = cc[x];
            continue;
          }
          const MT* c = t.col(st, x);
          uint32_t W = t.window(vv, x, dprev);
          uint32_t c6c = cc[x], c6r = cc[x + 1];
          uint32_t delta = 0;
          uint32_t todo = ~word & ~(word >> 8) & ((1u << hh) - 1);
          while (todo) {
            int j = __builtin_ctz(todo);
            todo &= todo - 1;
            MT m = c[j];
            uint64_t av = (uint64_t)(m & MAGMASK);
            int sig = (int)((av >> bitplane) & 1);
            mq.encode(sig, zc[nb9(W, j, vsc)]);
            if (sig) {
              int sign = (int)(m >> MSBIT);
              int si = sc_index_w(W, c6l, c6c, c6r, j, vsc);
              mq.encode(sign ^ SPB_LUT[si], SC_LUT[si]);
              W |= 2u << (3 * (j + 1));
              delta |= 1u << (j + 1);
              word |= 1u << j;
              if (sign) { word |= 1u << (4 + j); c6c |= 1u << (j + 1); }
              if (NM) nm += nmsedec_sig(av, bitplane);
            }
          }
          Sr[x] = (uint16_t)(word & 0xF0FFu);    // clear pi like the model
          dprev = delta;
          c6l = c6c;
        }
        if (full) {
          bool done = true;
          for (int x = 0; x < w; x++)
            if ((Sr[x] & 0xFu) != 0xFu) { done = false; break; }
          stripe_done[st] = done ? 1 : 0;
        }
      }
      if (style & S_SEGSYM) {
        mq.encode(1, CTX_UNI); mq.encode(0, CTX_UNI);
        mq.encode(1, CTX_UNI); mq.encode(0, CTX_UNI);
      }
    }

    bool term = terminating(bitplane, maxbp, pass_type, style);
    if (term) {
      if (raw) mq.bypass_flush(style & S_PTERM);
      else if (style & S_PTERM) mq.erterm();
      else mq.flush();
      prev_term = true;
    }
    pass_rates[pass_idx] = mq.num_bytes();
    pass_terms[pass_idx] = term ? 1 : 0;
    pass_bitplanes[pass_idx] = bitplane;
    pass_nmsedec[pass_idx] = (int)nm;

    if (style & S_RESET) {
      memset(mq.ctx, 0, NUMCTX);
      mq.ctx[CTX_UNI] = 46; mq.ctx[CTX_RL] = 3; mq.ctx[0] = 4;
    }
    pass_idx++;
    if (pass_type == 2) { pass_type = 0; bitplane--; } else pass_type++;
  }

  if (!prev_term) mq.flush();
  int n = mq.num_bytes();
  if (pass_idx > 0) {
    pass_rates[pass_idx - 1] = n;
    pass_terms[pass_idx - 1] = 1;
  }
  *numbps_out = numbps;
  *npasses_out = pass_idx;
  if (n > out_cap) return -1;
  memcpy(out, mq.buf.data() + 1, n);
  return n;
}

}  // namespace

// engine select: the denormalized column-flags engine (default) vs the
// normalized-flag T1N experiment (byte-identical; see struct T1N).
// GDCT_T1_ENGINE=1 opts into T1N; env-read per call so one process can
// A/B both. T1N is kept as a measured NEGATIVE result: removing every
// in-scan neighbor store (the BENCHMARKS.md 4i "store->load web"
// hypothesis) is 4-5% SLOWER on dense/textured 512^2 and ~14% on
// sparse blocks — the scan is not store-bound, the serial MQ chain is
// the wall (experiment #10 in BENCHMARKS.md 4i).
static bool t1n_engine() {
  const char* e = getenv("GDCT_T1_ENGINE");
  return e && e[0] == '1';
}

template <typename MT, typename ST>
static int t1_encode_vsc_nm(const ST* src, int w, int h, int style,
                            int orient, int roishift, uint8_t* out,
                            int out_cap, int* numbps_out, int* npasses_out,
                            int* pass_rates, uint8_t* pass_terms,
                            int* pass_bitplanes, int* pass_nmsedec,
                            int max_passes, int need_nmse) {
  const bool vsc = (style & S_VSC) != 0;
  if (t1n_engine()) {
    if (need_nmse)
      return vsc ? t1_encode_impl_n<MT, true, true>(
                       src, w, h, style, orient, roishift, out, out_cap,
                       numbps_out, npasses_out, pass_rates, pass_terms,
                       pass_bitplanes, pass_nmsedec, max_passes)
                 : t1_encode_impl_n<MT, false, true>(
                       src, w, h, style, orient, roishift, out, out_cap,
                       numbps_out, npasses_out, pass_rates, pass_terms,
                       pass_bitplanes, pass_nmsedec, max_passes);
    return vsc ? t1_encode_impl_n<MT, true, false>(
                     src, w, h, style, orient, roishift, out, out_cap,
                     numbps_out, npasses_out, pass_rates, pass_terms,
                     pass_bitplanes, pass_nmsedec, max_passes)
               : t1_encode_impl_n<MT, false, false>(
                     src, w, h, style, orient, roishift, out, out_cap,
                     numbps_out, npasses_out, pass_rates, pass_terms,
                     pass_bitplanes, pass_nmsedec, max_passes);
  }
  if (need_nmse)
    return vsc ? t1_encode_impl<MT, true, true>(
                     src, w, h, style, orient, roishift, out, out_cap,
                     numbps_out, npasses_out, pass_rates, pass_terms,
                     pass_bitplanes, pass_nmsedec, max_passes)
               : t1_encode_impl<MT, false, true>(
                     src, w, h, style, orient, roishift, out, out_cap,
                     numbps_out, npasses_out, pass_rates, pass_terms,
                     pass_bitplanes, pass_nmsedec, max_passes);
  return vsc ? t1_encode_impl<MT, true, false>(
                   src, w, h, style, orient, roishift, out, out_cap,
                   numbps_out, npasses_out, pass_rates, pass_terms,
                   pass_bitplanes, pass_nmsedec, max_passes)
             : t1_encode_impl<MT, false, false>(
                   src, w, h, style, orient, roishift, out, out_cap,
                   numbps_out, npasses_out, pass_rates, pass_terms,
                   pass_bitplanes, pass_nmsedec, max_passes);
}

template <typename ST>
static int t1_encode_any(const ST* src, int w, int h, int style, int orient,
                         int roishift, uint8_t* out, int out_cap,
                         int* numbps_out, int* npasses_out, int* pass_rates,
                         uint8_t* pass_terms, int* pass_bitplanes,
                         int* pass_nmsedec, int max_passes,
                         int need_nmse) {
  uint64_t maxabs = 0;
  for (long i = 0; i < (long)w * h; i++) {
    int64_t v = (int64_t)src[i];
    uint64_t av = (uint64_t)(v < 0 ? -v : v);
    if (av > maxabs) maxabs = av;
  }
  if (maxabs < (1u << 30))
    return t1_encode_vsc_nm<uint32_t>(
        src, w, h, style, orient, roishift, out, out_cap, numbps_out,
        npasses_out, pass_rates, pass_terms, pass_bitplanes, pass_nmsedec,
        max_passes, need_nmse);
  return t1_encode_vsc_nm<uint64_t>(
      src, w, h, style, orient, roishift, out, out_cap, numbps_out,
      npasses_out, pass_rates, pass_terms, pass_bitplanes, pass_nmsedec,
      max_passes, need_nmse);
}

// ---- per-codeblock thread pool ---------------------------------------------
// Code-blocks are coded independently (ISO 15444-1 Annex D: no state
// crosses a block), so the batched *_blocks entry points fan blocks out
// across threads and reassemble in block order — the output bytes are
// identical to the serial loop for any thread count. Worker count:
// GDCT_THREADS env (re-read per call so tests can flip it), else
// std::thread::hardware_concurrency(). All coder scratch is call-local
// or thread_local; the LUTs are immutable.
static int batch_threads(int nb) {
  const char* e = getenv("GDCT_THREADS");
  long v = e ? strtol(e, nullptr, 10)
             : (long)std::thread::hardware_concurrency();
  if (v < 1) v = 1;
  if (v > nb) v = nb;
  if (v > 64) v = 64;
  return (int)v;
}

// Run fn(i) for i in [0, nb): dynamic index striping via an atomic
// counter (blocks vary wildly in cost — dense LL vs empty HH).
template <typename F>
static void parallel_blocks(int nb, int nthreads, F&& fn) {
  if (nthreads <= 1) {
    for (int i = 0; i < nb; i++) fn(i);
    return;
  }
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= nb) return;
      fn(i);
    }
  };
  std::vector<std::thread> ths;
  ths.reserve((size_t)nthreads - 1);
  for (int t = 0; t < nthreads - 1; t++) ths.emplace_back(work);
  work();
  for (auto& th : ths) th.join();
}

extern "C" {

// Encode one code-block. Returns stream length, or -1 on error.
// out_* arrays must have capacity >= max_passes. Dispatches to the
// 32-bit magnitude engine unless a coefficient needs more than 30
// magnitude bits (deep ROI shifts).
int t1_encode(const int64_t* src, int w, int h, int style, int orient,
              int roishift, uint8_t* out, int out_cap, int* numbps_out,
              int* npasses_out, int* pass_rates, uint8_t* pass_terms,
              int* pass_bitplanes, int* pass_nmsedec, int max_passes,
              int need_nmse) {
  return t1_encode_any(src, w, h, style, orient, roishift, out, out_cap,
                       numbps_out, npasses_out, pass_rates, pass_terms,
                       pass_bitplanes, pass_nmsedec, max_passes,
                       need_nmse);
}

// int32 source variant: skips the Python-side int64 widening copy
int t1_encode32(const int32_t* src, int w, int h, int style, int orient,
                int roishift, uint8_t* out, int out_cap, int* numbps_out,
                int* npasses_out, int* pass_rates, uint8_t* pass_terms,
                int* pass_bitplanes, int* pass_nmsedec, int max_passes,
                int need_nmse) {
  return t1_encode_any(src, w, h, style, orient, roishift, out, out_cap,
                       numbps_out, npasses_out, pass_rates, pass_terms,
                       pass_bitplanes, pass_nmsedec, max_passes,
                       need_nmse);
}

// Batched code-block encode: every block of a tile in ONE call (cuts
// the per-block ctypes/alloc overhead of 70+ calls per 512^2 frame to
// one). Blocks are concatenated row-major in `src` at sample offsets
// `offsets` (nb+1 entries); per-block stream bytes land concatenated
// in `out` with byte offsets in `out_offsets` (nb+1). Pass arrays are
// strided by max_passes per block. Same per-block semantics as
// t1_encode32 (style/need_nmse shared, orient per block, roishift 0 —
// the ROI pre-shift happens upstream on the coefficients).
int t1_encode_blocks(const int32_t* src, const int64_t* offsets,
                     const int32_t* ws, const int32_t* hs,
                     const int32_t* orients, int nb, int style,
                     int need_nmse, uint8_t* out, long out_cap,
                     int64_t* out_offsets, int* numbps_out,
                     int* npasses_out, int* pass_rates,
                     uint8_t* pass_terms, int* pass_bitplanes,
                     int* pass_nmsedec, int max_passes) {
  int nthreads = batch_threads(nb);
  if (nthreads > 1) {
    // parallel: per-block temp regions sized to the caller's bound
    // (native/__init__.py: size*6 + 1024 per block), then a serial
    // in-order concat — bytes identical to the serial loop below. A
    // block that overflows its slice reports -1 and the whole call
    // falls back to the caller's scalar path (same recovery as a
    // serial overflow).
    std::vector<int64_t> toff((size_t)nb + 1, 0);
    for (int i = 0; i < nb; i++)
      toff[i + 1] =
          toff[i] + (int64_t)ws[i] * hs[i] * 6 + 1024;
    std::vector<uint8_t> tmp((size_t)toff[nb]);
    std::vector<int> lens((size_t)nb, 0);
    std::atomic<bool> err(false);
    parallel_blocks(nb, nthreads, [&](int i) {
      if (err.load(std::memory_order_relaxed)) return;
      int n = t1_encode_any(
          src + offsets[i], ws[i], hs[i], style, orients[i], 0,
          tmp.data() + toff[i],
          (int)std::min<int64_t>(toff[i + 1] - toff[i], 1 << 30),
          numbps_out + i, npasses_out + i,
          pass_rates + (size_t)i * max_passes,
          pass_terms + (size_t)i * max_passes,
          pass_bitplanes + (size_t)i * max_passes,
          pass_nmsedec + (size_t)i * max_passes, max_passes, need_nmse);
      if (n < 0) {
        err.store(true, std::memory_order_relaxed);
        return;
      }
      lens[i] = n;
    });
    if (err.load()) return -1;
    long o = 0;
    out_offsets[0] = 0;
    for (int i = 0; i < nb; i++) {
      if (o + lens[i] > out_cap) return -1;
      memcpy(out + o, tmp.data() + toff[i], (size_t)lens[i]);
      o += lens[i];
      out_offsets[i + 1] = o;
    }
    return (int)(o > INT32_MAX ? -1 : o);
  }
  long o = 0;
  out_offsets[0] = 0;
  for (int i = 0; i < nb; i++) {
    int n = t1_encode_any(
        src + offsets[i], ws[i], hs[i], style, orients[i], 0, out + o,
        (int)std::min<long>(out_cap - o, 1 << 30), numbps_out + i,
        npasses_out + i, pass_rates + (size_t)i * max_passes,
        pass_terms + (size_t)i * max_passes,
        pass_bitplanes + (size_t)i * max_passes,
        pass_nmsedec + (size_t)i * max_passes, max_passes, need_nmse);
    if (n < 0) return -1;
    o += n;
    out_offsets[i + 1] = o;
  }
  return (int)(o > INT32_MAX ? -1 : o);
}

// MSB-first bit writer with a 64-bit accumulator; optional JPEG
// FF->FF00 stuffing on emitted bytes.
struct BitW {
  uint64_t acc = 0;
  int nacc = 0;
  uint8_t* out;
  long cap;
  long o = 0;
  bool stuff;
  BitW(uint8_t* out_, long cap_, bool stuff_)
      : out(out_), cap(cap_), stuff(stuff_) {}
  inline bool put(uint64_t v, int len) {  // len <= 32
    acc = (acc << len) | (v & ((len >= 64) ? ~0ull : ((1ull << len) - 1)));
    nacc += len;
    while (nacc >= 8) {
      uint8_t byte = (uint8_t)(acc >> (nacc - 8));
      nacc -= 8;
      if (o >= cap) return false;
      out[o++] = byte;
      if (stuff && byte == 0xFF) {
        if (o >= cap) return false;
        out[o++] = 0;
      }
    }
    return true;
  }
  inline bool pad(int pad_bit) {
    if (!nacc) return true;
    int fill = 8 - nacc;
    return put(pad_bit ? ((1ull << fill) - 1) : 0ull, fill);
  }
};

// Pack (value, bit-length) pairs MSB-first into out. Returns byte count
// or -1 on overflow. Mirrors utils/npbits.pack_bits_msb.
int pack_bits_msb(const int64_t* values, const int64_t* lengths, long n,
                  int pad_bit, uint8_t* out, long out_cap) {
  BitW w(out, out_cap, false);
  for (long i = 0; i < n; i++) {
    int len = (int)lengths[i];
    if (len <= 0) continue;
    if (!w.put((uint64_t)values[i], len)) return -1;
  }
  if (!w.pad(pad_bit)) return -1;
  return (int)w.o;
}

// JPEG entropy de-stuffing (mirror of utils/npbits.destuff_ff): drop
// the 0x00 after every 0xFF and both bytes of embedded RSTn markers.
// out must have room for n bytes; returns the destuffed length.
long jpg_destuff(const uint8_t* src, long n, uint8_t* out) {
  long o = 0, i = 0;
  while (i < n) {
    const uint8_t* p =
        (const uint8_t*)memchr(src + i, 0xFF, (size_t)(n - i));
    long j = p ? (long)(p - src) : n;
    memcpy(out + o, src + i, (size_t)(j - i));
    o += j - i;
    i = j;
    if (i >= n) break;
    if (i + 1 < n) {
      uint8_t nx = src[i + 1];
      if (nx == 0x00) { out[o++] = 0xFF; i += 2; continue; }
      if (nx >= 0xD0 && nx <= 0xD7) { i += 2; continue; }
    }
    out[o++] = 0xFF;
    i++;
  }
  return o;
}

// PackBits (DICOM RLE Annex G) segment decode. Returns 0, -1 on literal
// overrun, -2 on missing replicate byte. Mirrors rlepack.packbits_decode.
int packbits_decode(const uint8_t* src, long src_len, uint8_t* out,
                    long expected) {
  long i = 0, pos = 0;
  memset(out, 0, (size_t)expected);
  while (i < src_len && pos < expected) {
    int control = src[i++];
    if (control < 128) {            // literal of control+1 bytes
      long len = control + 1;
      if (src_len - i < len) return -1;
      long take = len < expected - pos ? len : expected - pos;
      memcpy(out + pos, src + i, (size_t)take);
      i += len;
      pos += take;
    } else if (control > 128) {     // replicate 257-control copies
      long len = 257 - control;
      if (i >= src_len) return -2;
      long take = len < expected - pos ? len : expected - pos;
      memset(out + pos, src[i], (size_t)take);
      i += 1;
      pos += take;
    }                                // control == 128: no-op
  }
  return 0;
}

// PackBits (DICOM RLE Annex G) segment encode: runs >=3 replicate
// (chunked <=128), shorter runs merge into literal regions (chunked
// <=128) — byte-identical to entropy/rlepack.packbits_encode. Returns
// output length or -1 on overflow.
long packbits_encode(const uint8_t* seg, long n, uint8_t* out,
                     long out_cap) {
  long i = 0, o = 0;
  long lit_start = -1;
  auto flush_lit = [&](long end) -> bool {
    while (lit_start >= 0 && lit_start < end) {
      long len = end - lit_start;
      if (len > 128) len = 128;
      if (o + 1 + len > out_cap) return false;
      out[o++] = (uint8_t)(len - 1);
      memcpy(out + o, seg + lit_start, (size_t)len);
      o += len;
      lit_start += len;
    }
    lit_start = -1;
    return true;
  };
  // byte lanes where v has a zero byte (classic haszero trick)
  auto zlanes = [](uint64_t v) -> uint64_t {
    return (v - 0x0101010101010101ULL) & ~v & 0x8080808080808080ULL;
  };
  while (i < n) {
    // wordwise literal skip: advance i to the first position where a
    // run of >=3 equal bytes begins (the only place the byte-at-a-time
    // algorithm below leaves literal mode) — same segmentation, ~6
    // bytes per iteration instead of 1
    while (i + 8 <= n) {
      uint64_t x;
      memcpy(&x, seg + i, 8);
      // lane k: seg[i+k]==seg[i+k+1] (valid k<7) / ==seg[i+k+2] (k<6)
      uint64_t run3 = zlanes(x ^ (x >> 8)) & zlanes(x ^ (x >> 16)) &
                      0x0000808080808080ULL;
      if (run3) {
        long adv = __builtin_ctzll(run3) >> 3;
        if (adv && lit_start < 0) lit_start = i;
        i += adv;
        break;
      }
      if (lit_start < 0) lit_start = i;
      i += 6;  // a run of 3 could straddle the last two lanes
    }
    if (i >= n) break;
    long j = i + 1;
    {
      // wordwise run measurement
      uint64_t pat = 0x0101010101010101ULL * seg[i];
      while (j + 8 <= n) {
        uint64_t x;
        memcpy(&x, seg + j, 8);
        if (x != pat) { j += __builtin_ctzll(x ^ pat) >> 3; goto run_done; }
        j += 8;
      }
      while (j < n && seg[j] == seg[i]) j++;
    }
  run_done:;
    long run = j - i;
    if (run >= 3) {
      if (!flush_lit(i)) return -1;
      while (run > 0) {
        long len = run > 128 ? 128 : run;
        if (o + 2 > out_cap) return -1;
        out[o++] = (uint8_t)((257 - len) & 0xFF);
        out[o++] = seg[i];
        run -= len;
      }
    } else {
      if (lit_start < 0) lit_start = i;
    }
    i = j;
  }
  if (!flush_lit(n)) return -1;
  return o;
}

// One-pass JPEG lossless (P14) scan pack: per diff, Huffman code of the
// magnitude category + category extend bits, with 0xFF->0xFF00 stuffing.
// codes/lens: [17] per-category Huffman code (MSB-aligned value) and
// bit length. Category 16 = -32768, no extend bits (T.81 / reference
// huffman_encoder.go:125-133). Returns byte count or -1 on overflow.
long p14_pack_scan(const int64_t* diffs, long n, const int32_t* codes,
                   const int32_t* lens, uint8_t* out, long out_cap) {
  BitW w(out, out_cap, true);
  for (long i = 0; i < n; i++) {
    int64_t d = diffs[i];
    int cat;
    uint32_t ebits = 0;
    if (d == -32768) {
      cat = 16;
    } else {
      uint64_t a = (uint64_t)(d < 0 ? -d : d);
      cat = a ? 64 - __builtin_clzll(a) : 0;
      if (cat) {
        ebits = (uint32_t)(d < 0 ? d + (1 << cat) - 1 : d);
      }
    }
    if (!w.put((uint64_t)codes[cat], lens[cat])) return -1;
    if (cat && cat != 16) {
      if (!w.put(ebits, cat)) return -1;
    }
  }
  if (!w.pad(1)) return -1;
  return w.o;
}

// Histogram of P14 magnitude categories (17 bins) for optimal-table
// construction.
void p14_cat_hist(const int64_t* diffs, long n, int64_t* hist17) {
  for (int i = 0; i < 17; i++) hist17[i] = 0;
  for (long i = 0; i < n; i++) {
    int64_t d = diffs[i];
    int cat;
    if (d == -32768) cat = 16;
    else {
      int64_t a = d < 0 ? -d : d;
      cat = 0;
      while (a) { cat++; a >>= 1; }
    }
    hist17[cat]++;
  }
}

}  // pause extern "C" for the templated scan walker

// ---- sequential-DCT scan encode (baseline/extended), native ---------------
// Symbol traversal identical to codecs/jpeg_common.build_scan_symbols:
// per block (all components share the MCU index), per component:
// DC category+extend, then per AC nonzero run/16 ZRLs + RS, then EOB when
// the last nonzero is before position 63.

static inline int jpg_cat(int64_t d) {
  if (d == -32768) return 16;
  uint64_t a = (uint64_t)(d < 0 ? -d : d);
  return a ? 64 - __builtin_clzll(a) : 0;
}

// bit k set <=> blk[k] != 0 (one vectorizable pass; lets the AC loop
// visit only nonzero coefficients instead of all 64)
static inline uint64_t jpg_nz_mask(const int32_t* blk) {
#if defined(__AVX2__)
  uint64_t m = 0;
  const __m256i zero = _mm256_setzero_si256();
  for (int j = 0; j < 8; j++) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(blk + j * 8));
    int zb = _mm256_movemask_ps(
        _mm256_castsi256_ps(_mm256_cmpeq_epi32(v, zero)));
    m |= (uint64_t)(~zb & 0xFF) << (j * 8);
  }
  return m;
#else
  uint64_t m = 0;
  for (int k = 0; k < 64; k++)
    if (blk[k]) m |= 1ull << k;
  return m;
#endif
}

// visit(sym, is_dc, tid, ebits, elen)
template <typename F>
static void jpg_scan_walk(const int32_t* zz, int ncomp, long nblocks,
                          const int32_t* tids, int restart, F&& visit) {
  std::vector<int64_t> prev_dc(ncomp, 0);
  for (long b = 0; b < nblocks; b++) {
    if (restart && b % restart == 0)
      for (int c = 0; c < ncomp; c++) prev_dc[c] = 0;
    for (int c = 0; c < ncomp; c++) {
      const int32_t* blk = zz + ((size_t)c * nblocks + b) * 64;
      int tid = tids[c];
      int64_t diff = (int64_t)blk[0] - prev_dc[c];
      prev_dc[c] = blk[0];
      int cat = jpg_cat(diff);
      uint32_t eb = 0;
      if (cat && cat != 16)
        eb = (uint32_t)(diff < 0 ? diff + (1 << cat) - 1 : diff);
      visit(cat, true, tid, eb, cat == 16 ? 0 : cat);
      int last_nz = 0;
      uint64_t m = jpg_nz_mask(blk) & ~1ull;
      while (m) {
        int k2 = __builtin_ctzll(m);
        m &= m - 1;
        int run = k2 - last_nz - 1;
        while (run >= 16) { visit(0xF0, false, tid, 0, 0); run -= 16; }
        int32_t v = blk[k2];
        int ac = jpg_cat(v);
        uint32_t aeb = (uint32_t)(v < 0 ? v + (1 << ac) - 1 : v);
        visit((run << 4) | ac, false, tid, aeb, ac);
        last_nz = k2;
      }
      if (last_nz < 63) visit(0x00, false, tid, 0, 0);
    }
  }
}

extern "C" {

// Symbol histograms per table id (dc_hist/ac_hist: int64 [4*256]).
void jpg_scan_hist(const int32_t* zz, int ncomp, long nblocks,
                   const int32_t* tids, int restart,
                   int64_t* dc_hist, int64_t* ac_hist) {
  memset(dc_hist, 0, sizeof(int64_t) * 4 * 256);
  memset(ac_hist, 0, sizeof(int64_t) * 4 * 256);
  jpg_scan_walk(zz, ncomp, nblocks, tids, restart,
                [&](int sym, bool is_dc, int tid, uint32_t, int) {
                  (is_dc ? dc_hist : ac_hist)[tid * 256 + sym]++;
                });
}

// Huffman-code the scan with FF stuffing (+RSTn between intervals).
// codes/lens: int32 [4*256] per class. Returns bytes or -1.
long jpg_encode_scan2(const int32_t* zz, int ncomp, long nblocks,
                      const int32_t* tids, int restart,
                      const int32_t* dc_codes, const int32_t* dc_lens,
                      const int32_t* ac_codes, const int32_t* ac_lens,
                      uint8_t* out, long out_cap) {
  // two-pass per restart interval: raw MSB-first pack (no per-byte
  // bounds/stuff branches), then one memchr FF->FF00 stuffing pass;
  // RSTn markers are appended unstuffed between intervals. Raw bound:
  // every symbol is <= 32 bits = 4 bytes.
  std::unique_ptr<uint8_t[]> raw(
      new uint8_t[(size_t)nblocks * ncomp * 64 * 4 + 64]);  // uninit POD
  uint8_t* rp = raw.get();
  size_t ro = 0;
  // branchless MSB-first writer: acc holds pending bits left-aligned;
  // every put stores the full 8-byte window and advances by the whole
  // bytes completed (callers pass len <= 32, nacc stays < 8 after).
  uint64_t acc = 0;
  int nacc = 0;
  auto put = [&](uint64_t v, int len) {
    if (!len) return;  // len==0 with nacc==0 would be a 64-bit shift (UB)
    acc |= (v & ((1ull << len) - 1)) << (64 - nacc - len);
    nacc += len;
    uint64_t wv = __builtin_bswap64(acc);
    memcpy(rp + ro, &wv, 8);
    int nb = nacc >> 3;
    ro += nb;
    acc <<= nb * 8;
    nacc &= 7;
  };
  // opportunistic symbol pairing: pending bits accumulate up to 48 and
  // flush in one put — halves the serial acc/bswap/store chain length
  uint64_t pv = 0;
  int pl = 0;
  auto emit = [&](uint64_t v, int len) {
    if (pl + len > 48) {
      put(pv, pl);
      pv = 0;
      pl = 0;
    }
    pv = (pv << len) | (v & ((1ull << len) - 1));
    pl += len;
  };
  auto emit_flush = [&]() {
    if (pl) {
      put(pv, pl);
      pv = 0;
      pl = 0;
    }
  };
  long o = 0;
  auto flush_interval = [&]() -> bool {
    emit_flush();
    if (nacc) {  // pad to byte with 1-bits (nacc < 8; put emits it)
      int fill = 8 - nacc;
      put((1u << fill) - 1, fill);
    }
    size_t i = 0;
    while (i < ro) {
      const uint8_t* ff = (const uint8_t*)memchr(rp + i, 0xFF, ro - i);
      size_t run = ff ? (size_t)(ff - (rp + i)) : ro - i;
      if (o + (long)run + 2 > out_cap) return false;
      memcpy(out + o, rp + i, run);
      o += run;
      i += run;
      if (ff) {
        out[o++] = 0xFF;
        out[o++] = 0x00;
        i++;
      }
    }
    ro = 0;
    return true;
  };

  long interval = 0;
  std::vector<int64_t> prev_dc(ncomp, 0);
  for (long b = 0; b < nblocks; b++) {
    if (restart && b > 0 && b % restart == 0) {
      if (!flush_interval()) return -1;
      if (o + 2 > out_cap) return -1;
      out[o++] = 0xFF;
      out[o++] = (uint8_t)(0xD0 + (interval % 8));
      interval++;
      for (int c = 0; c < ncomp; c++) prev_dc[c] = 0;
    }
    for (int c = 0; c < ncomp; c++) {
      const int32_t* blk = zz + ((size_t)c * nblocks + b) * 64;
      int tid = tids[c];
      const int32_t* dcod = dc_codes + tid * 256;
      const int32_t* dlen = dc_lens + tid * 256;
      const int32_t* acod = ac_codes + tid * 256;
      const int32_t* alen = ac_lens + tid * 256;
      int64_t diff = (int64_t)blk[0] - prev_dc[c];
      prev_dc[c] = blk[0];
      int cat = jpg_cat(diff);
      if (!dlen[cat]) return -1;
      if (cat && cat != 16) {
        uint32_t eb = (uint32_t)(diff < 0 ? diff + (1 << cat) - 1 : diff) &
                      ((1u << cat) - 1);
        emit(((uint64_t)(uint32_t)dcod[cat] << cat) | eb, dlen[cat] + cat);
      } else {
        emit((uint32_t)dcod[cat], dlen[cat]);
      }
      int last_nz = 0;
      uint64_t m = jpg_nz_mask(blk) & ~1ull;
      while (m) {
        int k2 = __builtin_ctzll(m);
        m &= m - 1;
        int run = k2 - last_nz - 1;
        while (run >= 16) {
          if (!alen[0xF0]) return -1;
          emit((uint32_t)acod[0xF0], alen[0xF0]);
          run -= 16;
        }
        int32_t v = blk[k2];
        // branchless category + extend bits (v != 0 here)
        int32_t sgn = v >> 31;
        uint32_t a = (uint32_t)((v ^ sgn) - sgn);
        int ac = 32 - __builtin_clz(a);
        int sym = (run << 4) | ac;
        if (!alen[sym]) return -1;
        uint32_t aeb =
            (uint32_t)(v + (sgn & (int32_t)((1u << ac) - 1))) &
            ((1u << ac) - 1);
        emit(((uint64_t)(uint32_t)acod[sym] << ac) | aeb, alen[sym] + ac);
        last_nz = k2;
      }
      if (last_nz < 63) {
        if (!alen[0]) return -1;
        emit((uint32_t)acod[0], alen[0]);
      }
    }
  }
  if (!flush_interval()) return -1;
  return o;
}

}  // extern "C"

namespace {

// Decode one code-block into out (templated pass engine; see T1CF).
template <typename MT, bool VSC, typename OT>
int t1_decode_impl(const uint8_t* stream, int stream_len, int w, int h,
                   int style, int orient, int num_passes, int numbps,
                   int roishift, const int32_t* seg_ends, int n_segs,
                   int ojp_recon, OT* out_data) {
  constexpr MT MSB = T1CF<MT>::MSB;
  constexpr MT MAGMASK = T1CF<MT>::MAGMASK;
  build_luts();
  T1CF<MT> t(w, h);
  int nstripes = t.nstripes;
  if (numbps <= 0 || num_passes <= 0) {
    memset(out_data, 0, sizeof(OT) * (size_t)w * h);
    return 0;
  }
  int maxbp = numbps - 1;

  // termination pattern
  std::vector<uint8_t> term(num_passes, 0);
  {
    int pt = 2, bp_ = maxbp;
    for (int i = 0; i < num_passes; i++) {
      term[i] = terminating(bp_, maxbp, pt, style) ? 1 : 0;
      if (pt == 2) { pt = 0; bp_--; } else pt++;
    }
  }
  bool use_segs = n_segs > 0;
  {
    bool any_mid = false;
    for (int i = 0; i + 1 < num_passes; i++) if (term[i]) any_mid = true;
    use_segs = use_segs && any_mid;
  }

  MQDec mq;
  RawDec rd;
  bool is_raw_active = false;
  uint8_t saved_ctx[NUMCTX];
  bool have_ctx = false;
  int seg_idx = 0, seg_start = 0;
  const uint8_t* seg_ptr = stream;
  int seg_len = stream_len;
  if (use_segs) {
    int end = seg_ends[0];
    if (end > stream_len) end = stream_len;
    seg_ptr = stream; seg_len = end; seg_start = end;
  }

  bool need_new = true;
  int pass_type = 2, bitplane = maxbp, pass_idx = 0;
  const uint8_t* zc = ZC_LUT[orient];
  constexpr bool vsc = VSC;
  constexpr uint32_t vsig = VSC ? (SIG18 & ~SIG_ROW4) : SIG18;
  // mirror of the encoder's completed-stripe skip (see t1_encode_impl)
  std::vector<uint8_t> stripe_done((size_t)nstripes, 0);
  // mirror of the encoder's whole-stripe MRP steady flag (stripe_refss)
  std::vector<uint8_t> stripe_refss((size_t)nstripes, 0);

  // magnitude|sign representation: new significance sets the plane bit
  // and the sign MSB; refinement adds the plane bit to the magnitude.
  // ojp_recon = OpenJPEG one-plus-half mid-bin rules (reference
  // t1/decoder.go:630-646, enabled by the tile decoder at
  // t2/tile_decoder.go:594): exact for fully-decoded blocks, mid-bin
  // at the lowest decoded plane for truncated ones.
  // ojp_recon decodes in a doubled domain (one-plus-half at 2^(bp+1))
  // and halves at unpack: exact for complete blocks, mid-bin at the
  // lowest decoded plane for truncated ones (reference
  // t1/decoder.go:630-646 + tile_decoder.go:989-993, transposed to the
  // unshifted coefficient domain this T1 codes).
  auto recon_sig = [&](int bp_, int sign) -> MT {
    MT v = ojp_recon ? (((MT)1 << (bp_ + 1)) | ((MT)1 << bp_))
                     : ((MT)1 << bp_);
    return v | (sign ? MSB : (MT)0);
  };
  auto recon_ref = [&](MT cur, int bp_, int bit) -> MT {
    // branchless forms (identical arithmetic: ±poshalf ==
    // -poshalf + bit*2*poshalf) — the steady-stripe bulk loops below
    // feed this per bit and want it select-free
    if (!ojp_recon) return cur + ((MT)bit << bp_);
    MT poshalf = (MT)1 << bp_;
    MT mag = (cur & MAGMASK) - poshalf + ((MT)bit << (bp_ + 1));
    return mag | (cur & MSB);
  };

  while (bitplane >= 0 && pass_idx < num_passes) {
    if (pass_type == 0 || (pass_type == 2 && pass_idx == 0)) {
      for (auto& f : t.F) f &= ~PI4;
      if (roishift > 0 && bitplane >= roishift) {
        pass_type = 0; bitplane--; continue;
      }
    }
    bool raw = lazy_raw(bitplane, maxbp, pass_type, style);
    if (need_new) {
      if (raw) { rd.init(seg_ptr, seg_len); is_raw_active = true; }
      else {
        bool reset = (style & S_RESET) != 0;
        mq.init(seg_ptr, seg_len, (!have_ctx || reset) ? nullptr : saved_ctx);
        if (!have_ctx || reset) {
          mq.ctx[CTX_UNI] = 46; mq.ctx[CTX_RL] = 3; mq.ctx[0] = 4;
        }
        is_raw_active = false;
      }
      need_new = false;
    }

    if (pass_type == 0) {  // SPP
      for (int st = 0; st < nstripes; st++) {
        if (stripe_done[st]) continue;
        int hh = h - st * 4; if (hh > 4) hh = 4;
        uint32_t* Fr = t.fw(st);
        for (int x = 0; x < w; x++) {
          uint32_t f = Fr[x];
          if (!(f & SIG18)) continue;
          if (hh == 4 && (f & SIGMA_MID4) == SIGMA_MID4)
            continue;                   // steady state: all 4 significant
          MT* c = t.col(st, x);
          uint32_t todo = ~sig_nibble(f) & ((1u << hh) - 1);
          while (todo) {
            int j = __builtin_ctz(todo);
            todo &= todo - 1;
            uint32_t g = nb9(f, j, vsc);
            if (!(g & 0x1EFu)) continue;
            int sig = raw ? rd.decode() : mq.decode(zc[g]);
            f |= 1u << (18 + j);
            if (sig) {
              int sign;
              if (raw) sign = rd.decode();
              else {
                int si = sc_index_cf(f, Fr[x - 1], Fr[x + 1], j, vsc);
                sign = mq.decode(SC_LUT[si]) ^ SPB_LUT[si];
              }
              c[j] = recon_sig(bitplane, sign);
              t.set_sig_f(st, x, j, sign, f);
            }
          }
          Fr[x] = f;
        }
      }
    } else if (pass_type == 1) {  // MRP
      for (int st = 0; st < nstripes; st++) {
        int hh = h - st * 4; if (hh > 4) hh = 4;
        uint32_t* Fr = t.fw(st);
        if (hh == 4 && !stripe_refss[st]) {
          bool all = true;
          for (int x = 0; x < w; x++)
            if ((Fr[x] & (SIGMA_MID4 | PI4 | MU4)) != (SIGMA_MID4 | MU4)) {
              all = false; break;
            }
          stripe_refss[st] = all ? 1 : 0;
        }
        if (stripe_refss[st]) {
          // whole-stripe steady state (encoder mirror): 4*w consecutive
          // refinement bits over contiguous dataS; flags unchanged
          MT* cb = t.col(st, 0);
          if (raw) {
            int x = 0;
            for (; x + 8 <= w; x += 8) {
              uint32_t v = rd.decode_n(32);
              MT* c = cb + (size_t)4 * x;
#if defined(__AVX2__)
              if constexpr (sizeof(MT) == 4) {
                scatter_ref_bits32(c, bitplane, v, ojp_recon != 0);
              } else
#endif
              {
                for (int k = 0; k < 32; k++)
                  c[k] = recon_ref(c[k], bitplane,
                                   (int)((v >> (31 - k)) & 1));
              }
            }
            for (; x < w; x++) {
              uint32_t nib = rd.decode_n(4);
              MT* c = cb + (size_t)4 * x;
              for (int j = 0; j < 4; j++)
                c[j] = recon_ref(c[j], bitplane,
                                 (int)((nib >> (3 - j)) & 1));
            }
          } else {
            uint8_t s16 = mq.ctx[16];
            for (int x = 0; x < w; x++) {
              MT* c = cb + (size_t)4 * x;
              for (int j = 0; j < 4; j++)
                c[j] = recon_ref(c[j], bitplane, mq.decode_s(s16));
            }
            mq.ctx[16] = s16;
          }
          continue;
        }
        for (int x = 0; x < w; x++) {
          uint32_t f = Fr[x];
          if (!(f & SIGMA_MID4)) continue;
          MT* c = t.col(st, x);
          if (hh == 4 &&
              (f & (SIGMA_MID4 | PI4 | MU4)) == (SIGMA_MID4 | MU4)) {
            // steady state mirror of the encoder fast path (raw MRP
            // dominates lazy dense low planes)
            if (raw) {
              uint32_t nib = rd.decode_n(4);
              for (int j = 0; j < 4; j++)
                c[j] = recon_ref(c[j], bitplane,
                                 (int)((nib >> (3 - j)) & 1));
            } else
              for (int j = 0; j < 4; j++)
                c[j] = recon_ref(c[j], bitplane, mq.decode(16));
            continue;
          }
          uint32_t todo = sig_nibble(f) & ~(f >> 18) & ((1u << hh) - 1);
          while (todo) {
            int j = __builtin_ctz(todo);
            todo &= todo - 1;
            int bit = raw ? rd.decode()
                          : mq.decode(mr_context_cf(f, j, vsc));
            c[j] = recon_ref(c[j], bitplane, bit);
            f |= 1u << (22 + j);
          }
          Fr[x] = f;
        }
      }
    } else {  // CP
      for (int st = 0; st < nstripes; st++) {
        if (stripe_done[st]) continue;
        int hh = h - st * 4; if (hh > 4) hh = 4;
        bool full = hh == 4;
        uint32_t* Fr = t.fw(st);
        for (int x = 0; x < w; x++) {
          uint32_t f = Fr[x];
          if (full && !(f & (vsig | PI4))) {
            if (!mq.decode(CTX_RL)) continue;
            int rl_pos = (mq.decode(CTX_UNI) << 1) | mq.decode(CTX_UNI);
            MT* c = t.col(st, x);
            bool partial = true;
            for (int j = rl_pos; j < 4; j++) {
              int sig;
              if (partial) { sig = 1; partial = false; }
              else sig = mq.decode(zc[nb9(f, j, vsc)]);
              if (sig) {
                int si = sc_index_cf(f, Fr[x - 1], Fr[x + 1], j, vsc);
                int sign = mq.decode(SC_LUT[si]) ^ SPB_LUT[si];
                c[j] = recon_sig(bitplane, sign);
                t.set_sig_f(st, x, j, sign, f);
              }
            }
            Fr[x] = f;
            continue;
          }
          if ((f & SIGMA_MID4) == SIGMA_MID4) {
            Fr[x] = f & ~PI4;  // steady state: nothing left to clean up
            continue;
          }
          MT* c = t.col(st, x);
          uint32_t todo = ~sig_nibble(f) & ~(f >> 18) & ((1u << hh) - 1);
          while (todo) {
            int j = __builtin_ctz(todo);
            todo &= todo - 1;
            int sig = mq.decode(zc[nb9(f, j, vsc)]);
            if (sig) {
              int si = sc_index_cf(f, Fr[x - 1], Fr[x + 1], j, vsc);
              int sign = mq.decode(SC_LUT[si]) ^ SPB_LUT[si];
              c[j] = recon_sig(bitplane, sign);
              t.set_sig_f(st, x, j, sign, f);
            }
          }
          Fr[x] = f & ~PI4;
        }
        if (full) {
          bool done = true;
          for (int x = 0; x < w; x++)
            if ((Fr[x] & SIGMA_MID4) != SIGMA_MID4) { done = false; break; }
          stripe_done[st] = done ? 1 : 0;
        }
      }
      if (style & S_SEGSYM)
        for (int i = 0; i < 4; i++) mq.decode(CTX_UNI);
    }

    if (style & S_RESET) {
      if (!is_raw_active) {
        memset(mq.ctx, 0, NUMCTX);
        mq.ctx[CTX_UNI] = 46; mq.ctx[CTX_RL] = 3; mq.ctx[0] = 4;
      }
      have_ctx = false;
    } else if (!is_raw_active) {
      memcpy(saved_ctx, mq.ctx, NUMCTX);
      have_ctx = true;
    }

    if (term[pass_idx] && pass_idx + 1 < num_passes) {
      if (use_segs) {
        seg_idx++;
        if (seg_idx < n_segs) {
          int end = seg_ends[seg_idx];
          if (end > stream_len) end = stream_len;
          seg_ptr = stream + seg_start;
          seg_len = end - seg_start;
          if (seg_len < 0) seg_len = 0;
          seg_start = end;
        } else { seg_ptr = stream; seg_len = 0; }
      }
      need_new = true;
    }

    pass_idx++;
    if (pass_type == 2) { pass_type = 0; bitplane--; } else pass_type++;
  }

  for (int y = 0; y < h; y++) {
    const MT* base = t.dataS.data() + (size_t)(y >> 2) * w * 4 + (y & 3);
    OT* row = out_data + (size_t)y * w;
    for (int x = 0; x < w; x++) {
      MT m = base[(size_t)x * 4];
      int64_t mag = (int64_t)(m & MAGMASK);
      if (ojp_recon) mag >>= 1;  // out of the doubled domain
      row[x] = (OT)((m & MSB) ? -mag : mag);
    }
  }
  return 0;
}

}  // namespace

template <typename OT>
static int t1_decode_any(const uint8_t* stream, int stream_len, int w, int h,
                         int style, int orient, int num_passes, int numbps,
                         int roishift, const int32_t* seg_ends, int n_segs,
                         int ojp_recon, OT* out_data) {
  const bool vsc = (style & S_VSC) != 0;
  if (numbps <= 29)
    return vsc ? t1_decode_impl<uint32_t, true>(
                     stream, stream_len, w, h, style, orient, num_passes,
                     numbps, roishift, seg_ends, n_segs, ojp_recon,
                     out_data)
               : t1_decode_impl<uint32_t, false>(
                     stream, stream_len, w, h, style, orient, num_passes,
                     numbps, roishift, seg_ends, n_segs, ojp_recon,
                     out_data);
  return vsc ? t1_decode_impl<uint64_t, true>(
                   stream, stream_len, w, h, style, orient, num_passes,
                   numbps, roishift, seg_ends, n_segs, ojp_recon, out_data)
             : t1_decode_impl<uint64_t, false>(
                   stream, stream_len, w, h, style, orient, num_passes,
                   numbps, roishift, seg_ends, n_segs, ojp_recon,
                   out_data);
}

extern "C" {

// Decode one code-block into out (int64 [h*w]). Returns 0, or -1 on
// error. 32-bit magnitude engine unless the declared bit depth could
// overflow 30 magnitude bits.
int t1_decode(const uint8_t* stream, int stream_len, int w, int h, int style,
              int orient, int num_passes, int numbps, int roishift,
              const int32_t* seg_ends, int n_segs, int ojp_recon,
              int64_t* out_data) {
  return t1_decode_any(stream, stream_len, w, h, style, orient, num_passes,
                       numbps, roishift, seg_ends, n_segs, ojp_recon,
                       out_data);
}

// int32 output variant: skips the Python-side narrowing copy
int t1_decode32(const uint8_t* stream, int stream_len, int w, int h,
                int style, int orient, int num_passes, int numbps,
                int roishift, const int32_t* seg_ends, int n_segs,
                int ojp_recon, int32_t* out_data) {
  return t1_decode_any(stream, stream_len, w, h, style, orient, num_passes,
                       numbps, roishift, seg_ends, n_segs, ojp_recon,
                       out_data);
}

// Batched decode: every (non-ROI, numbps<=30) code-block of a tile in
// one call. Streams concatenated at byte offsets `stream_offsets`
// (nb+1); per-block segment-end lists concatenated in `all_seg_ends`
// at `seg_offsets` (nb+1); int32 outputs concatenated at sample
// offsets `out_offsets` (nb+1, caller-computed as w*h prefix sums).
// Per-block status lands in `status` (0 ok, else the t1_decode32
// code); a failed block leaves its output zeroed and the caller
// re-runs it through the scalar path for exact error semantics.
int t1_decode_blocks(const uint8_t* streams, const int64_t* stream_offsets,
                     const int32_t* ws, const int32_t* hs,
                     const int32_t* orients, const int32_t* num_passes_a,
                     const int32_t* numbps_a, const int32_t* all_seg_ends,
                     const int64_t* seg_offsets, int nb, int style,
                     int ojp_recon, int32_t* out,
                     const int64_t* out_offsets, int32_t* status) {
  // blocks decode into disjoint out/status slots — directly parallel
  parallel_blocks(nb, batch_threads(nb), [&](int i) {
    int n_segs = (int)(seg_offsets[i + 1] - seg_offsets[i]);
    status[i] = t1_decode_any(
        streams + stream_offsets[i],
        (int)(stream_offsets[i + 1] - stream_offsets[i]), ws[i], hs[i],
        style, orients[i], num_passes_a[i], numbps_a[i], 0,
        all_seg_ends + seg_offsets[i], n_segs, ojp_recon,
        out + out_offsets[i]);
  });
  return 0;
}

}  // extern "C"

// ============================================================================
// Tier-2 packet assembly fast path — exact mirror of t2/packets.py
// encode_packet + t2/tagtree.py + t2/bitio.py (the Python modules are
// the behavioral reference, pinned by tests/test_native.py; reference
// semantics jpeg2000/t2/packet_header_tagtree.go:15-162, tagtree.go,
// packet_header_bitio.go). One call assembles EVERY packet of a tile
// in progression order — headers, tag trees, Lblock state, and body
// byte copies all native.
// ============================================================================

namespace t2n {

// B.10.1 bit writer: a 0xFF byte is followed by a 7-bit byte
struct Bio {
  std::vector<uint8_t>& buf;
  uint32_t out = 0;
  int ct = 8;
  explicit Bio(std::vector<uint8_t>& b) : buf(b) {}
  inline void byte_out() {
    out = (out << 8) & 0xFFFF;
    ct = (out == 0xFF00) ? 7 : 8;
    buf.push_back((uint8_t)((out >> 8) & 0xFF));
  }
  inline void put_bit(int bit) {
    if (ct == 0) byte_out();
    ct--;
    if (bit) out |= 1u << ct;
  }
  inline void put_bits(uint32_t value, int n) {
    while (n > 0) {
      if (ct == 0) byte_out();
      int take = ct < n ? ct : n;
      n -= take;
      ct -= take;
      out |= ((value >> n) & ((1u << take) - 1)) << ct;
    }
  }
  inline void flush() {
    byte_out();
    if (ct == 7) byte_out();
  }
};

// quad-tree of minima (t2/tagtree.py; values/low/known per level)
struct Tag {
  int width, height, levels;
  std::vector<std::pair<int, int>> dims;       // (w, h) per level
  std::vector<std::vector<int>> value, low;
  std::vector<std::vector<uint8_t>> known;
  void init(int w_, int h_) {
    width = w_ > 0 ? w_ : 1;
    height = h_ > 0 ? h_ : 1;
    dims.clear();
    int w = width, h = height;
    for (;;) {
      dims.push_back({w, h});
      if (w == 1 && h == 1) break;
      w = (w + 1) / 2;
      h = (h + 1) / 2;
    }
    levels = (int)dims.size();
    reset();
  }
  void reset() {
    value.assign(levels, {});
    low.assign(levels, {});
    known.assign(levels, {});
    for (int l = 0; l < levels; l++) {
      value[l].assign((size_t)dims[l].first * dims[l].second, 999);
      low[l].assign((size_t)dims[l].first * dims[l].second, 0);
      known[l].assign((size_t)dims[l].first * dims[l].second, 0);
    }
  }
  void set_value(int x, int y, int v) {
    int px = x, py = y;
    for (int l = 0; l < levels; l++) {
      int idx = py * dims[l].first + px;
      if (value[l][idx] > v) value[l][idx] = v;
      else break;
      px /= 2;
      py /= 2;
    }
  }
  void encode(Bio& bw, int x, int y, int threshold) {
    // walk root -> leaf
    int chain[32][2], n = 0;
    int px = x, py = y;
    for (int l = 0; l < levels; l++) {
      chain[n][0] = l;
      chain[n][1] = py * dims[l].first + px;
      n++;
      px /= 2;
      py /= 2;
    }
    int lo = 0;
    for (int i = n - 1; i >= 0; i--) {
      int l = chain[i][0], idx = chain[i][1];
      if (lo > low[l][idx]) low[l][idx] = lo;
      else lo = low[l][idx];
      while (lo < threshold) {
        if (lo >= value[l][idx]) {
          if (!known[l][idx]) {
            bw.put_bit(1);
            known[l][idx] = 1;
          }
          break;
        }
        bw.put_bit(0);
        lo++;
      }
      low[l][idx] = lo;
    }
  }
};

// comma code for pass counts (B.10.6; t2/packets.py _encode_num_passes)
inline int put_num_passes(Bio& bw, int n) {
  if (n == 1) bw.put_bit(0);
  else if (n == 2) bw.put_bits(2, 2);
  else if (n <= 5) bw.put_bits(0x0C | (n - 3), 4);
  else if (n <= 36) bw.put_bits(0x1E0 | (n - 6), 9);
  else if (n <= 164) bw.put_bits(0xFF80 | (n - 37), 16);
  else return -1;
  return 0;
}

inline int floor_log2(int n) {
  if (n <= 1) return 0;
  return 31 - __builtin_clz((unsigned)n);
}

// pass counts per terminated segment for passes [start, start+new)
// (t2/packets.py _segments; same termination walk as the T1 coder)
inline int segments_of(int style, int numbps, int start_pass,
                       int new_passes, int* segs) {
  if (style & 0x40) {
    // HT sets (T.814 B.2): pass walk [cleanup, SigProp, MagRef];
    // boundaries at pass indices == 0 and == 2 (mod 3)
    int nsegs = 0, count = 0;
    for (int idx = start_pass; idx < start_pass + new_passes; idx++) {
      count++;
      if (idx % 3 != 1 || idx == start_pass + new_passes - 1) {
        segs[nsegs++] = count;
        count = 0;
      }
    }
    return nsegs;
  }
  if (numbps <= 0) {
    if (new_passes) {
      segs[0] = new_passes;
      return 1;
    }
    return 0;
  }
  int maxbp = numbps - 1;
  int nsegs = 0, count = 0;
  int pass_type = 2, bitplane = maxbp, idx = 0;
  while (idx < start_pass + new_passes && bitplane >= 0) {
    if (idx >= start_pass) {
      count++;
      bool last = idx == start_pass + new_passes - 1;
      if (terminating(bitplane, maxbp, pass_type, style) || last) {
        segs[nsegs++] = count;
        count = 0;
      }
    }
    idx++;
    if (pass_type == 2) {
      pass_type = 0;
      bitplane--;
    } else {
      pass_type++;
    }
  }
  if (count) segs[nsegs++] = count;
  return nsegs;
}

// B.10.1 bit reader (t2/bitio.py BioReader): a 0xFF byte is followed
// by a 7-bit byte. Throws no exceptions — end-of-data sets `bad`.
struct BioR {
  const uint8_t* data;
  long len, pos = 0;
  uint32_t buf = 0;
  int ct = 0;
  bool bad = false;
  BioR(const uint8_t* d, long n) : data(d), len(n) {}
  inline void byte_in() {
    if (pos >= len) {
      bad = true;
      ct = 8;  // keep callers terminating
      return;
    }
    buf = (buf << 8) & 0xFFFF;
    ct = (buf == 0xFF00) ? 7 : 8;
    buf |= data[pos++];
  }
  inline int get_bit() {
    if (ct == 0) byte_in();
    ct--;
    return (int)((buf >> ct) & 1);
  }
  inline uint32_t get_bits(int n) {
    uint32_t v = 0;
    while (n > 0) {
      if (ct == 0) byte_in();
      int take = ct < n ? ct : n;
      ct -= take;
      v = (v << take) | ((buf >> ct) & ((1u << take) - 1));
      n -= take;
    }
    return v;
  }
  inline void align() {
    // opj_bio_inalign: consume the stuffed byte after a trailing 0xFF
    if ((buf & 0xFF) == 0xFF) byte_in();
    ct = 0;
  }
};

struct TagDec {
  int width, height, levels;
  std::vector<std::pair<int, int>> dims;
  std::vector<std::vector<int>> value, low;
  void init(int w_, int h_) {
    width = w_ > 0 ? w_ : 1;
    height = h_ > 0 ? h_ : 1;
    dims.clear();
    int w = width, h = height;
    for (;;) {
      dims.push_back({w, h});
      if (w == 1 && h == 1) break;
      w = (w + 1) / 2;
      h = (h + 1) / 2;
    }
    levels = (int)dims.size();
    reset();
  }
  void reset() {
    value.assign(levels, {});
    low.assign(levels, {});
    for (int l = 0; l < levels; l++) {
      value[l].assign((size_t)dims[l].first * dims[l].second, 999);
      low[l].assign((size_t)dims[l].first * dims[l].second, 0);
    }
  }
  int decode(BioR& br, int x, int y, int threshold) {
    int chain[32][2], n = 0;
    int px = x, py = y;
    for (int l = 0; l < levels; l++) {
      chain[n][0] = l;
      chain[n][1] = py * dims[l].first + px;
      n++;
      px /= 2;
      py /= 2;
    }
    int lo = 0;
    for (int i = n - 1; i >= 0; i--) {
      int l = chain[i][0], idx = chain[i][1];
      if (lo > low[l][idx]) low[l][idx] = lo;
      else lo = low[l][idx];
      while (lo < threshold && lo < value[l][idx]) {
        if (br.get_bit()) value[l][idx] = lo;
        else lo++;
        if (br.bad) return -1;
      }
      low[l][idx] = lo;
    }
    return value[0][y * width + x];
  }
};

inline int get_num_passes(BioR& br) {
  if (br.get_bit() == 0) return 1;
  if (br.get_bit() == 0) return 2;
  uint32_t v = br.get_bits(2);
  if (v < 3) return 3 + (int)v;
  v = br.get_bits(5);
  if (v < 31) return 6 + (int)v;
  return 37 + (int)br.get_bits(7);
}

// whether global pass idx is terminating (t2/packets.py _terminates_at)
inline bool terminates_at(int style, int numbps, int idx) {
  if (style & 0x40) return idx % 3 != 1;  // HT sets (T.814 B.2)
  if (numbps <= 0) return false;
  int maxbp = numbps - 1;
  int pass_type = 2, bitplane = maxbp, i = 0;
  while (bitplane >= 0) {
    if (i == idx) return terminating(bitplane, maxbp, pass_type, style);
    i++;
    if (pass_type == 2) {
      pass_type = 0;
      bitplane--;
    } else {
      pass_type++;
    }
  }
  return false;
}

}  // namespace t2n

extern "C" {

// Assemble every packet of a tile. Block tables (global, one entry per
// code-block of the tile, band-contiguous):
//   cbx/cby/zbp/numbps  per block
//   rates (int32) at rate_offsets[b]..rate_offsets[b+1] (cumulative
//   per-pass byte rates), layer passes (int32, cumulative per layer)
//   at lp_offsets (lp_offsets[b]==lp_offsets[b+1] -> unlayered: every
//   pass ships in its first packet), stream bytes at data_offsets.
// Band table: ncbw/ncbh/blk_start/blk_count per band.
// Packets: for packet p, layer[p] and band ids at
//   pkt_bands[pkt_band_offsets[p]..pkt_band_offsets[p+1]).
// Returns total bytes written to out, or -1 on overflow/error.
long t2_assemble_packets(
    const int32_t* cbx, const int32_t* cby, const int32_t* zbp,
    const int32_t* numbps, const int64_t* rate_offsets,
    const int32_t* rates, const uint8_t* terms_unused,
    const int64_t* lp_offsets, const int32_t* layer_passes,
    const int64_t* data_offsets, const uint8_t* data, int nblocks,
    const int32_t* ncbw, const int32_t* ncbh, const int32_t* blk_start,
    const int32_t* blk_count, int nbands, const int32_t* pkt_layer,
    const int64_t* pkt_band_offsets, const int32_t* pkt_bands,
    int npackets, int style, uint8_t* out, long out_cap,
    int measure_only) {
  // measure_only: count bytes exactly (headers fully coded, Lblock and
  // tag-tree state advanced) but write nothing — the PCRD bisection
  // only needs the total
  (void)terms_unused;
  const bool wr = !measure_only;
  using namespace t2n;
  std::vector<Tag> incl(nbands), zbpt(nbands);
  for (int b = 0; b < nbands; b++) {
    incl[b].init(ncbw[b], ncbh[b]);
    zbpt[b].init(ncbw[b], ncbh[b]);
  }
  std::vector<int> num_passes(nblocks, 0), lblock(nblocks, 3);
  std::vector<uint8_t> included(nblocks, 0);
  std::vector<uint8_t> hdr;
  hdr.reserve(256);
  long o = 0;
  int segs[192];

  for (int p = 0; p < npackets; p++) {
    int layer = pkt_layer[p];
    const int32_t* bids = pkt_bands + pkt_band_offsets[p];
    int nb = (int)(pkt_band_offsets[p + 1] - pkt_band_offsets[p]);
    hdr.clear();
    Bio bw(hdr);

    bool any_blocks = false;
    for (int k = 0; k < nb; k++)
      if (blk_count[bids[k]] > 0) any_blocks = true;
    if (!any_blocks) {
      bw.put_bit(0);
      bw.flush();
      if (wr) {
        if (o + (long)hdr.size() > out_cap) return -1;
        memcpy(out + o, hdr.data(), hdr.size());
      }
      o += (long)hdr.size();
      continue;
    }

    bool nonempty = false;
    for (int k = 0; k < nb; k++) {
      int b = bids[k];
      for (int i = blk_start[b]; i < blk_start[b] + blk_count[b]; i++) {
        int total =
            (lp_offsets[i + 1] > lp_offsets[i])
                ? layer_passes[lp_offsets[i] + layer]
                : (int)(rate_offsets[i + 1] - rate_offsets[i]);
        if (total - num_passes[i] > 0) nonempty = true;
      }
    }

    if (layer == 0) {
      for (int k = 0; k < nb; k++) {
        int b = bids[k];
        incl[b].reset();
        zbpt[b].reset();
        for (int i = blk_start[b]; i < blk_start[b] + blk_count[b]; i++)
          zbpt[b].set_value(cbx[i], cby[i], zbp[i]);
      }
    }
    // first-inclusion min-propagation BEFORE any encode touches a tree
    for (int k = 0; k < nb; k++) {
      int b = bids[k];
      for (int i = blk_start[b]; i < blk_start[b] + blk_count[b]; i++) {
        int total =
            (lp_offsets[i + 1] > lp_offsets[i])
                ? layer_passes[lp_offsets[i] + layer]
                : (int)(rate_offsets[i + 1] - rate_offsets[i]);
        if (!included[i] && total - num_passes[i] > 0)
          incl[b].set_value(cbx[i], cby[i], layer);
      }
    }

    if (!nonempty) {
      bw.put_bit(0);
      bw.flush();
      if (wr) {
        if (o + (long)hdr.size() > out_cap) return -1;
        memcpy(out + o, hdr.data(), hdr.size());
      }
      o += (long)hdr.size();
      continue;
    }
    bw.put_bit(1);

    long body_len = 0;
    for (int k = 0; k < nb; k++) {
      int b = bids[k];
      for (int i = blk_start[b]; i < blk_start[b] + blk_count[b]; i++) {
        int prev = num_passes[i];
        int total =
            (lp_offsets[i + 1] > lp_offsets[i])
                ? layer_passes[lp_offsets[i] + layer]
                : (int)(rate_offsets[i + 1] - rate_offsets[i]);
        int new_passes = total - prev;
        bool inc = new_passes > 0;
        if (!included[i]) {
          incl[b].encode(bw, cbx[i], cby[i], layer + 1);
          if (!inc) continue;
          zbpt[b].encode(bw, cbx[i], cby[i], 999);
          included[i] = 1;
        } else {
          bw.put_bit(inc ? 1 : 0);
          if (!inc) continue;
        }
        if (put_num_passes(bw, new_passes) < 0) return -1;

        int nsegs = segments_of(style, numbps[i], prev, new_passes, segs);
        const int32_t* r = rates + rate_offsets[i];
        int increment = 0;
        int pp = prev;
        int seg_lens[192];
        for (int s = 0; s < nsegs; s++) {
          int end = pp + segs[s];
          int start_b = pp > 0 ? r[pp - 1] : 0;
          int end_b = r[end - 1];
          seg_lens[s] = end_b - start_b;
          int need = (floor_log2(seg_lens[s]) + 1) -
                     (lblock[i] + floor_log2(segs[s]));
          if (need > increment) increment = need;
          pp = end;
        }
        for (int s = 0; s < increment; s++) bw.put_bit(1);
        bw.put_bit(0);
        lblock[i] += increment;
        for (int s = 0; s < nsegs; s++)
          bw.put_bits((uint32_t)seg_lens[s],
                      lblock[i] + floor_log2(segs[s]));
        int start_b = prev > 0 ? r[prev - 1] : 0;
        int end_b = r[prev + new_passes - 1];
        body_len += end_b - start_b;
      }
    }
    bw.flush();
    if (wr) {
      if (o + (long)hdr.size() + body_len > out_cap) return -1;
      memcpy(out + o, hdr.data(), hdr.size());
    }
    o += (long)hdr.size();
    // body: new pass bytes per contributing block, band order
    for (int k = 0; k < nb; k++) {
      int b = bids[k];
      for (int i = blk_start[b]; i < blk_start[b] + blk_count[b]; i++) {
        int prev = num_passes[i];
        int total =
            (lp_offsets[i + 1] > lp_offsets[i])
                ? layer_passes[lp_offsets[i] + layer]
                : (int)(rate_offsets[i + 1] - rate_offsets[i]);
        int new_passes = total - prev;
        if (new_passes <= 0) continue;
        const int32_t* r = rates + rate_offsets[i];
        int start_b = prev > 0 ? r[prev - 1] : 0;
        int end_b = r[prev + new_passes - 1];
        if (wr)
          memcpy(out + o, data + data_offsets[i] + start_b,
                 (size_t)(end_b - start_b));
        o += end_b - start_b;
        num_passes[i] = prev + new_passes;
      }
    }
  }
  return o;
}

// Parse every packet of a tile body (headers + body slicing — mirror
// of t2/packets.decode_packet over the full progression; STRICT mode
// only, the resilient/corrupt paths stay Python). Tables as in
// t2_assemble_packets, plus per-band mb and a per-packet style.
// Outputs: per block numbps/zbp/num_passes/included, contiguous
// seg_data bytes at o_data_offsets (o_segdata cap >= body_len), and
// seg_ends (cumulative in-block offsets) strided by max_segs.
// pkt_skip: per-packet PLT-recorded bitstream length, or -1 to parse
// normally — a non-negative entry advances pos without touching the
// packet's bytes (reduced-resolution decode skips dropped-resolution
// packets; mirror of the plt_skip branch in jpeg2000._decode_tile).
// Returns the final body position, or a negative error code (any
// error -> the caller reruns the Python reference path untouched).
long t2_parse_packets(
    const uint8_t* body, long body_len, const int32_t* cbx,
    const int32_t* cby, int nblocks, const int32_t* ncbw,
    const int32_t* ncbh, const int32_t* mb, const int32_t* blk_start,
    const int32_t* blk_count, int nbands, const int32_t* pkt_layer,
    const int32_t* pkt_style, const int64_t* pkt_band_offsets,
    const int32_t* pkt_bands, int npackets, int use_sop, int use_eph,
    int32_t* o_numbps, int32_t* o_zbp, int32_t* o_npasses,
    uint8_t* o_included, uint8_t* o_segdata, int64_t* o_data_offsets,
    int32_t* o_seg_ends, int32_t* o_seg_counts, int max_segs,
    const int64_t* pkt_skip) {
  using namespace t2n;
  std::vector<TagDec> incl(nbands), zbpt(nbands);
  for (int b = 0; b < nbands; b++) {
    incl[b].init(ncbw[b], ncbh[b]);
    zbpt[b].init(ncbw[b], ncbh[b]);
  }
  for (int i = 0; i < nblocks; i++) {
    o_numbps[i] = 0;
    o_zbp[i] = 0;
    o_npasses[i] = 0;
    o_included[i] = 0;
    o_seg_counts[i] = 0;
  }
  // parse phase records body slices; the copy phase below lays each
  // block's bytes out contiguously (a block's segments can arrive
  // across several packets/layers)
  struct Slice { int blk; long start, len; uint8_t is_end; };
  std::vector<Slice> slices;
  std::vector<long> blk_len(nblocks, 0);
  std::vector<int> lblock(nblocks, 3);
  int rd_blk[4096];
  int rd_np[4096];
  std::vector<std::vector<int>> rd_seglens;
  long pos = 0;

  for (int p = 0; p < npackets; p++) {
    int layer = pkt_layer[p];
    int style = pkt_style[p];
    if (pos >= body_len) {
      if (layer > 0) break;  // truncated layered stream
      return -2;
    }
    if (pkt_skip && pkt_skip[p] >= 0) {
      // PLT skip: bytes never read; clamp so a hostile length can't
      // overflow pos past the loop-top exhaustion check
      pos = (pkt_skip[p] > body_len - pos) ? body_len : pos + pkt_skip[p];
      continue;
    }
    if (use_sop && pos + 6 <= body_len && body[pos] == 0xFF &&
        body[pos + 1] == 0x91)
      pos += 6;
    BioR br(body + pos, body_len - pos);
    const int32_t* bids = pkt_bands + pkt_band_offsets[p];
    int nb = (int)(pkt_band_offsets[p + 1] - pkt_band_offsets[p]);
    if (layer == 0)
      for (int k = 0; k < nb; k++) {
        incl[bids[k]].reset();
        zbpt[bids[k]].reset();
      }
    int nreads = 0;
    rd_seglens.clear();
    if (br.get_bit()) {
      for (int k = 0; k < nb; k++) {
        int b = bids[k];
        for (int i = blk_start[b]; i < blk_start[b] + blk_count[b];
             i++) {
          if (!o_included[i]) {
            int incl_val = incl[b].decode(br, cbx[i], cby[i], layer + 1);
            if (incl_val < 0 || br.bad) return -3;
            if (incl_val > layer) continue;
            int thr = 1;
            for (;;) {
              int v = zbpt[b].decode(br, cbx[i], cby[i], thr);
              if (v < 0 || br.bad) return -3;
              if (v < thr) break;
              thr++;
              if (thr > 1200) return -3;
            }
            o_zbp[i] = zbpt[b].decode(br, cbx[i], cby[i], thr);
            o_numbps[i] = mb[b] - o_zbp[i];
            if (o_numbps[i] < 0) return -4;  // negative bitplane count
            o_included[i] = 1;
          } else {
            if (!br.get_bit()) continue;
          }
          if (br.bad) return -3;
          int new_passes = get_num_passes(br);
          int segs[192];
          int nsegs = segments_of(style, o_numbps[i], o_npasses[i],
                                  new_passes, segs);
          int increment = 0;
          while (br.get_bit()) {
            increment++;
            if (increment > 64 || br.bad) return -3;
          }
          lblock[i] += increment;
          if (nreads >= 4096 || nsegs > 190) return -5;
          rd_blk[nreads] = i;
          rd_np[nreads] = new_passes;
          rd_seglens.push_back({});
          auto& sl = rd_seglens.back();
          for (int s = 0; s < nsegs; s++) {
            int nbits = lblock[i] + floor_log2(segs[s]);
            // >31-bit length field: Python's arbitrary-precision read
            // would reject it as a body overrun — don't wrap here
            if (nbits > 31) return -5;
            sl.push_back((int)br.get_bits(nbits));
          }
          if (br.bad) return -3;
          nreads++;
        }
      }
    }
    if (br.bad) return -3;
    br.align();
    // align() itself can read past the end (stuffed byte after a
    // trailing 0xFF) — the Python reader raises there, so a strict
    // native parse must fail identically, not accept the stream
    if (br.bad) return -3;
    pos += br.pos;
    if (use_eph && pos + 2 <= body_len && body[pos] == 0xFF &&
        body[pos + 1] == 0x92)
      pos += 2;

    for (int t = 0; t < nreads; t++) {
      int i = rd_blk[t];
      int segs[192];
      int nsegs = segments_of(pkt_style[p], o_numbps[i], o_npasses[i],
                              rd_np[t], segs);
      int p_end = o_npasses[i];
      for (int s = 0; s < nsegs; s++) {
        long ln = rd_seglens[t][s];
        if (pos + ln > body_len) return -6;  // body overrun
        p_end += segs[s];
        bool is_end = terminates_at(pkt_style[p], o_numbps[i], p_end - 1);
        slices.push_back({i, pos, ln, (uint8_t)(is_end ? 1 : 0)});
        blk_len[i] += ln;
        if (is_end) {
          if (o_seg_counts[i] >= max_segs) return -5;
          o_seg_ends[(size_t)i * max_segs + o_seg_counts[i]++] =
              (int32_t)blk_len[i];
        }
        pos += ln;
      }
      o_npasses[i] += rd_np[t];
    }
  }

  // copy phase: contiguous per-block seg_data
  o_data_offsets[0] = 0;
  for (int i = 0; i < nblocks; i++)
    o_data_offsets[i + 1] = o_data_offsets[i] + blk_len[i];
  std::vector<long> fill(nblocks, 0);
  for (const Slice& s : slices) {
    memcpy(o_segdata + o_data_offsets[s.blk] + fill[s.blk],
           body + s.start, (size_t)s.len);
    fill[s.blk] += s.len;
  }
  return pos;
}

}  // extern "C"

// ============================================================================
// JPEG-LS scan coder fast path — exact mirror of codecs/jpegls.py
// (CharLS-compatible LOCO-I; the Python module is the behavioral reference,
// pinned by tests/test_native.py equivalence tests).
// ============================================================================

namespace jls {

const int J_[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct Traits {
  int maxval, near_, reset, t1, t2, t3;
  int range_, qbpp, limit;
  std::vector<int8_t> qlut;  // qgrad LUT over d in [-maxval, maxval]

  void init() {
    range_ = near_ == 0 ? maxval + 1
                        : (maxval + 2 * near_) / (2 * near_ + 1) + 1;
    auto log2ceil = [](int n) {
      if (n <= 1) return 1;
      int L = 0; n--;
      while (n > 0) { n >>= 1; L++; }
      return L;
    };
    qbpp = log2ceil(range_);
    int bpp = log2ceil(maxval);
    limit = 2 * (bpp + (bpp > 8 ? bpp : 8));
  }

  int quantize(int e) const {
    if (near_ == 0) return e;
    if (e > 0) return (e + near_) / (2 * near_ + 1);
    return -((near_ - e) / (2 * near_ + 1));
  }
  int dequantize(int e) const { return e * (2 * near_ + 1); }
  int modulo_range(int e) const {
    // branchless: both wrap conditions are ~coin flips on real content
    e += range_ & -(int)(e < 0);
    e -= range_ & -(int)(e >= (range_ + 1) / 2);
    return e;
  }
  int compute_error(int e) const { return modulo_range(quantize(e)); }
  int correct_prediction(int p) const {
    return p < 0 ? 0 : (p > maxval ? maxval : p);
  }
  int fix_reconstructed(int v) const {
    if (near_ == 0 && ((maxval + 1) & maxval) == 0) return v & maxval;
    if (v < -near_) v += range_ * (2 * near_ + 1);
    else if (v > maxval + near_) v -= range_ * (2 * near_ + 1);
    return correct_prediction(v);
  }
  int reconstruct(int pred, int err) const {
    return fix_reconstructed(pred + dequantize(err));
  }
  int qgrad_slow(int d) const {
    if (d <= -t3) return -4;
    if (d <= -t2) return -3;
    if (d <= -t1) return -2;
    if (d < -near_) return -1;
    if (d <= near_) return 0;
    if (d < t1) return 1;
    if (d < t2) return 2;
    if (d < t3) return 3;
    return 4;
  }
  void build_qlut() {  // one lookup replaces the 8-way comparison chain
    qlut.resize((size_t)2 * maxval + 1);
    for (int d = -maxval; d <= maxval; d++)
      qlut[(size_t)(d + maxval)] = (int8_t)qgrad_slow(d);
  }
  inline int qgrad(int d) const { return qlut[(size_t)(d + maxval)]; }
  bool is_near(int a, int b) const {
    int d = a - b;
    return (d < 0 ? -d : d) <= near_;
  }
};

// zigzag forms — the sign branches are ~50% mispredicts per sample
inline int map_error(int e) { return (e << 1) ^ (e >> 31); }
inline int unmap_error(int v) { return (v >> 1) ^ -(v & 1); }
inline int apply_sign(int i, int s) { return (s ^ i) - s; }
inline int sgn(int n) { return n < 0 ? -1 : 1; }
// MED == clamp(ra+rb-rc, min(ra,rb), max(ra,rb)) — branch-free
// equivalent of the three-way comparison in T.87 A.4.2
inline int med_predict(int ra, int rb, int rc) {
  int mn = ra < rb ? ra : rb;
  int mx = ra ^ rb ^ mn;
  int p = ra + rb - rc;
  p = p < mn ? mn : p;
  return p > mx ? mx : p;
}

struct Ctx {
  int a, b, c, n;
  void init(int range_) {
    a = (range_ + 32) / 64;
    if (a < 2) a = 2;
    b = 0; c = 0; n = 1;
  }
  int golomb_k() const {
    // deliberately the branchy scan: k is stable per context, so the
    // exit branch predicts and speculation hides the whole computation;
    // a clz closed form measured 24% SLOWER e2e (pure data chain on the
    // serial critical path instead of a predicted branch)
    int k = 0;
    while ((n << k) < a && k < 16) k++;
    return k;
  }
  int error_correction(int k, int near_) const {
    if (k != 0 || near_ != 0) return 0;
    return 2 * b + n - 1 < 0 ? -1 : 0;
  }
  void update(int err, int near_, int reset) {
    a += err < 0 ? -err : err;
    b += err * (2 * near_ + 1);
    const int lim = 65536 * 256;
    if (a >= lim) a = lim - 1;
    if (b >= lim) b = lim - 1;
    else if (b <= -lim) b = -lim + 1;
    if (n == reset) { a >>= 1; b >>= 1; n >>= 1; }
    n++;
    // branchless bias adjustment (T.87 A.6.2): the b-direction branches
    // flip often enough on real content to mispredict
    int lo = b + n <= 0;
    int hi = (b > 0) & ~lo;
    int b1 = b + n;
    b1 = b1 <= -n ? -n + 1 : b1;
    int b2 = b - n;
    b2 = b2 > 0 ? 0 : b2;
    b = lo ? b1 : (hi ? b2 : b);
    c -= lo & (c > -128);
    c += hi & (c < 127);
  }
};

struct RunCtx {
  int rtype, a, n, nn;
  void init(int rt, int range_) {
    rtype = rt;
    a = (range_ + 32) / 64;
    if (a < 2) a = 2;
    n = 1; nn = 0;
  }
  int golomb_k() const {
    int temp = a + (n >> 1) * rtype;
    int ntest = n, k = 0;
    while (ntest < temp) { ntest <<= 1; if (++k > 32) break; }
    return k;
  }
  bool compute_map(int err, int k) const {
    if (k == 0 && err > 0 && 2 * nn < n) return true;
    if (err < 0 && 2 * nn >= n) return true;
    if (err < 0 && k != 0) return true;
    return false;
  }
  int error_from_mapped(int temp, int k) const {
    int map_bit = temp & 1;
    int err_abs = (temp + map_bit) / 2;
    bool cond = (k != 0) || (2 * nn >= n);
    if (cond == (map_bit != 0)) return -err_abs;
    return err_abs;
  }
  void update(int err, int emapped, int reset) {
    if (err < 0) nn++;
    a += (emapped + 1 - rtype) >> 1;
    if (n == reset) { a >>= 1; n >>= 1; nn >>= 1; }
    n++;
  }
};

struct GWriter {
  uint8_t* buf = nullptr;  // caller-provided scratch (worst-case sized)
  long n = 0;
  uint32_t bitbuf = 0;
  int free_ = 32;
  bool ff = false;

  void write_bits(uint32_t bits, int nb) {
    free_ -= nb;
    if (free_ >= 0) bitbuf |= bits << free_;
    else {
      bitbuf |= bits >> -free_;
      flush();
      if (free_ < 0) { bitbuf |= bits >> -free_; flush(); }
      bitbuf |= bits << free_;
    }
  }
  void flush() {
    for (int i = 0; i < 4; i++) {
      if (free_ >= 32) { free_ = 32; break; }
      uint8_t b;
      if (ff) { b = (bitbuf >> 25) & 0x7F; bitbuf <<= 7; free_ += 7; }
      else { b = (bitbuf >> 24) & 0xFF; bitbuf <<= 8; free_ += 8; }
      buf[n++] = b;
      ff = b == 0xFF;
    }
  }
  void finish() {
    flush();
    if (ff) write_bits(0, (free_ - 1) % 8);
    flush();
  }
  void write_unary(int n) {
    while (n + 1 > 31) { write_bits(0, 31); n -= 31; }
    write_bits(1, n + 1);
  }
  void write_zeros(int n) {
    while (n > 0) { int c = n > 31 ? 31 : n; write_bits(0, c); n -= c; }
  }
  void encode_mapped(int k, int mapped, int limit, int qbpp) {
    int high = mapped >> k;
    if (high < limit - (qbpp + 1)) {
      if (high + 1 > 31) { write_zeros(high / 2); high -= high / 2; }
      write_unary(high);
      if (k > 0) write_bits(mapped & ((1 << k) - 1), k);
      return;
    }
    int escape = limit - qbpp;
    if (escape > 31) { write_zeros(31); write_unary(escape - 31 - 1); }
    else write_unary(escape - 1);
    write_bits((mapped - 1) & ((1 << qbpp) - 1), qbpp);
  }
};

struct GReader {
  const uint8_t* data;
  int len, pos = 0;
  uint64_t cache = 0;
  int valid = 0;
  bool pff = false;  // last consumed byte was 0xFF (stuffed next byte)

  void fill() {
    // byte-at-a-time on purpose: a 48-bit bulk append over 0xFF-free
    // windows measured NEUTRAL at 8 and 12 bit (the reader is off the
    // serial critical path often enough that OOO already hides it)
    while (valid < 56) {
      if (pos >= len) {
        if (valid <= 0) { cache = (cache << 8) | 0xFF; valid += 8; continue; }
        break;
      }
      uint8_t b = data[pos];
      pos++;
      if (pff) { cache = (cache << 7) | (b & 0x7F); valid += 7; }
      else { cache = (cache << 8) | b; valid += 8; }
      pff = b == 0xFF;
    }
  }
  int read_bit() {
    if (valid == 0) { fill(); if (valid == 0) return 1; }
    valid--;
    return (cache >> valid) & 1;
  }
  int read_bits(int n) {
    if (n == 0) return 0;
    if (valid < n) fill();
    if (valid >= n) {
      valid -= n;
      return (int)((cache >> valid) & ((1ull << n) - 1));
    }
    int v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | read_bit();
    return v;
  }
  // unary run: count zeros up to the first 1 via the cached window
  int read_unary() {
    int high = 0;
    for (;;) {
      if (valid == 0) {
        fill();
        if (valid == 0) return high;  // exhausted: trailing ones pad
      }
      uint64_t window = cache & ((valid >= 64) ? ~0ull
                                               : ((1ull << valid) - 1));
      if (window == 0) {
        high += valid;
        valid = 0;
        if (high > 100000) return -1;
        continue;
      }
      int top = 63 - __builtin_clzll(window);
      high += valid - 1 - top;
      valid = top;  // consume the zeros and the terminating 1
      return high;
    }
  }
  int decode_value(int k, int limit, int qbpp) {
    int high = read_unary();
    if (high < 0) return -1;
    if (high >= limit - (qbpp + 1)) return read_bits(qbpp) + 1;
    if (k == 0) return high;
    return (high << k) + read_bits(k);
  }
};

struct Scan {
  Traits t;
  std::vector<Ctx> ctx;
  RunCtx rctx[2];
  int run_index = 0;

  void init() {
    ctx.resize(365);
    for (auto& c : ctx) c.init(t.range_);
    rctx[0].init(0, t.range_);
    rctx[1].init(1, t.range_);
    run_index = 0;
  }
  void inc_run() { if (run_index < 31) run_index++; }
  void dec_run() { if (run_index > 0) run_index--; }

  int context_id(int ra, int rb, int rc, int rd) const {
    int q1 = t.qgrad(rd - rb), q2 = t.qgrad(rb - rc), q3 = t.qgrad(rc - ra);
    return (q1 * 9 + q2) * 9 + q3;
  }

  int encode_regular(GWriter& gw, int x, int qs, int ra, int rb, int rc) {
    int sign = qs < 0 ? -1 : 0;
    Ctx& c = ctx[apply_sign(qs, sign)];
    int k = c.golomb_k();
    int pred = t.correct_prediction(med_predict(ra, rb, rc) +
                                    apply_sign(c.c, sign));
    int err = t.compute_error(apply_sign(x - pred, sign));
    int mapped = map_error(c.error_correction(k, t.near_) ^ err);
    gw.encode_mapped(k, mapped, t.limit, t.qbpp);
    c.update(err, t.near_, t.reset);
    return t.reconstruct(pred, apply_sign(err, sign));
  }

  int decode_regular(GReader& gr, int qs, int ra, int rb, int rc) {
    int sign = qs < 0 ? -1 : 0;
    Ctx& c = ctx[apply_sign(qs, sign)];
    int k = c.golomb_k();
    int pred = t.correct_prediction(med_predict(ra, rb, rc) +
                                    apply_sign(c.c, sign));
    int mapped = gr.decode_value(k, t.limit, t.qbpp);
    int err = c.error_correction(k, t.near_) ^ unmap_error(mapped);
    c.update(err, t.near_, t.reset);
    return t.reconstruct(pred, apply_sign(err, sign));
  }

  void encode_run_length(GWriter& gw, int run, bool eol) {
    while (run >= (1 << J_[run_index])) {
      gw.write_bits(1, 1);
      run -= 1 << J_[run_index];
      inc_run();
    }
    if (eol) { if (run != 0) gw.write_bits(1, 1); return; }
    gw.write_bits(run, J_[run_index] + 1);
  }

  int decode_run_length(GReader& gr, int remaining) {
    int run = 0;
    for (;;) {
      if (gr.read_bit() == 1) {
        int chunk = 1 << J_[run_index];
        int cnt = chunk < remaining - run ? chunk : remaining - run;
        run += cnt;
        if (cnt == chunk) inc_run();
        if (run >= remaining) return remaining;
      } else break;
    }
    if (J_[run_index] > 0) run += gr.read_bits(J_[run_index]);
    if (run > remaining) return -1;
    return run;
  }

  void encode_run_interruption(GWriter& gw, RunCtx& rc, int err) {
    int k = rc.golomb_k();
    bool map_bit = rc.compute_map(err, k);
    int emapped = 2 * (err < 0 ? -err : err) - rc.rtype - (map_bit ? 1 : 0);
    gw.encode_mapped(k, emapped, t.limit - J_[run_index] - 1, t.qbpp);
    rc.update(err, emapped, t.reset);
  }

  int decode_run_interruption(GReader& gr, RunCtx& rc) {
    int k = rc.golomb_k();
    int mapped = gr.decode_value(k, t.limit - J_[run_index] - 1, t.qbpp);
    int err = rc.error_from_mapped(mapped + rc.rtype, k);
    rc.update(err, mapped, t.reset);
    return err;
  }
};

// single-component scan (encode=true writes to gw, else reads gr)
template <bool ENC>
void code_one_line(Scan& s, GWriter* gw, GReader* gr, int64_t* row,
                   const int64_t* above, int w, int prev_first,
                   int prev_prev_first) {
  // one line of one component (the T.87 main loop; mirror of the
  // Python _code_one_line split). above == nullptr on line 0.
  Traits& t = s.t;
  int x = 0;
  while (x < w) {
    int ra, rb, rc, rd;
    if (x == 0) {
      ra = prev_first;
      rb = above ? prev_first : 0;
      rc = prev_prev_first;
      rd = (above && w > 1) ? (int)above[1] : rb;
    } else {
      ra = (int)row[x - 1];
      rb = above ? (int)above[x] : 0;
      rc = above ? (int)above[x - 1] : 0;
      rd = above ? (int)above[x + 1 < w ? x + 1 : w - 1] : rb;
    }
    int qs = s.context_id(ra, rb, rc, rd);
    if (qs != 0) {
      if (ENC) row[x] = s.encode_regular(*gw, (int)row[x], qs, ra, rb, rc);
      else row[x] = s.decode_regular(*gr, qs, ra, rb, rc);
      x++;
      continue;
    }
    int remaining = w - x;
    if (ENC) {
      int run = 0;
      while (run < remaining && t.is_near((int)row[x + run], ra)) {
        row[x + run] = ra;
        run++;
      }
      s.encode_run_length(*gw, run, run == remaining);
      if (run == remaining) { x += run; break; }
      int xi = (int)row[x + run];
      int rb2 = above ? (int)above[x + run] : 0;
      if (t.is_near(ra, rb2)) {
        int err = t.compute_error(xi - ra);
        s.encode_run_interruption(*gw, s.rctx[1], err);
        row[x + run] = t.reconstruct(ra, err);
      } else {
        int sg = sgn(rb2 - ra);
        int err = t.compute_error((xi - rb2) * sg);
        s.encode_run_interruption(*gw, s.rctx[0], err);
        row[x + run] = t.reconstruct(rb2, err * sg);
      }
      s.dec_run();
      x += run + 1;
    } else {
      int run = s.decode_run_length(*gr, remaining);
      if (run < 0) run = remaining;
      for (int i = 0; i < run; i++) row[x + i] = ra;
      if (run >= remaining) { x += run; break; }
      int rb2 = above ? (int)above[x + run] : 0;
      if (t.is_near(ra, rb2)) {
        int err = s.decode_run_interruption(*gr, s.rctx[1]);
        err = t.modulo_range(err);
        row[x + run] = t.reconstruct(ra, err);
      } else {
        int err = s.decode_run_interruption(*gr, s.rctx[0]);
        err = t.modulo_range(err * sgn(rb2 - ra));
        row[x + run] = t.reconstruct(rb2, err);
      }
      s.dec_run();
      x += run + 1;
    }
  }
}

template <bool ENC>
void code_component(Scan& s, GWriter* gw, GReader* gr, int64_t* plane,
                    int w, int h) {
  int prev_first = 0, prev_prev_first = 0;
  for (int y = 0; y < h; y++) {
    code_one_line<ENC>(s, gw, gr, plane + (size_t)y * w,
                       y > 0 ? plane + (size_t)(y - 1) * w : nullptr, w,
                       prev_first, prev_prev_first);
    prev_prev_first = prev_first;
    prev_first = (int)plane[(size_t)y * w];
  }
}

// line-interleaved scan (ILV=1): every line coded per component in
// component order — one shared set of context counters, RUNindex kept
// per component (T.87 A.2.1; mirror of _code_line_interleaved)
template <bool ENC>
void code_line_interleaved(Scan& s, GWriter* gw, GReader* gr, int64_t* img,
                           int w, int h, int ncomp) {
  std::vector<int64_t> planes((size_t)ncomp * w * h, 0);
  if (ENC)
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        for (int c = 0; c < ncomp; c++)
          planes[((size_t)c * h + y) * w + x] =
              img[((size_t)y * w + x) * ncomp + c];
  std::vector<int> pf(ncomp, 0), ppf(ncomp, 0), ri(ncomp, 0);
  for (int y = 0; y < h; y++)
    for (int c = 0; c < ncomp; c++) {
      int64_t* plane = planes.data() + (size_t)c * w * h;
      s.run_index = ri[c];
      code_one_line<ENC>(s, gw, gr, plane + (size_t)y * w,
                         y > 0 ? plane + (size_t)(y - 1) * w : nullptr, w,
                         pf[c], ppf[c]);
      ri[c] = s.run_index;
      ppf[c] = pf[c];
      pf[c] = (int)plane[(size_t)y * w];
    }
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++)
      for (int c = 0; c < ncomp; c++)
        img[((size_t)y * w + x) * ncomp + c] =
            planes[((size_t)c * h + y) * w + x];
}

// sample-interleaved scan (ILV=2), ncomp components
template <bool ENC>
void code_interleaved(Scan& s, GWriter* gw, GReader* gr, int64_t* img,
                      int w, int h, int ncomp) {
  Traits& t = s.t;
  std::vector<int> prev_first(ncomp, 0), prev_prev_first(ncomp, 0);
  auto px = [&](int x, int y, int c) -> int64_t& {
    return img[((size_t)y * w + x) * ncomp + c];
  };
  auto neighbors = [&](int x, int y, int c, int& ra, int& rb, int& rc,
                       int& rd) {
    if (x == 0) {
      ra = prev_first[c];
      rb = y > 0 ? prev_first[c] : 0;
      rc = prev_prev_first[c];
      rd = (y > 0 && w > 1) ? (int)px(1, y - 1, c) : rb;
      return;
    }
    ra = (int)px(x - 1, y, c);
    rb = y > 0 ? (int)px(x, y - 1, c) : 0;
    rc = y > 0 ? (int)px(x - 1, y - 1, c) : 0;
    rd = y > 0 ? (int)px(x + 1 < w ? x + 1 : w - 1, y - 1, c) : rb;
  };

  for (int y = 0; y < h; y++) {
    int x = 0;
    while (x < w) {
      int ra[4], rb[4], rc[4], rd[4], qs[4];
      bool any = false;
      for (int c = 0; c < ncomp; c++) {
        neighbors(x, y, c, ra[c], rb[c], rc[c], rd[c]);
        qs[c] = s.context_id(ra[c], rb[c], rc[c], rd[c]);
        if (qs[c] != 0) any = true;
      }
      if (any) {
        for (int c = 0; c < ncomp; c++) {
          if (ENC)
            px(x, y, c) = s.encode_regular(*gw, (int)px(x, y, c), qs[c],
                                           ra[c], rb[c], rc[c]);
          else
            px(x, y, c) = s.decode_regular(*gr, qs[c], ra[c], rb[c], rc[c]);
        }
        x++;
        continue;
      }
      int remaining = w - x;
      if (ENC) {
        int run = 0;
        while (run < remaining) {
          bool ok = true;
          int left[4];
          for (int c = 0; c < ncomp; c++) {
            int a_, b_, c_, d_;
            neighbors(x + run, y, c, a_, b_, c_, d_);
            left[c] = a_;
            if (!t.is_near((int)px(x + run, y, c), a_)) { ok = false; break; }
          }
          if (!ok) break;
          for (int c = 0; c < ncomp; c++) px(x + run, y, c) = left[c];
          run++;
        }
        s.encode_run_length(*gw, run, run == remaining);
        if (run == remaining) { x += run; break; }
        for (int c = 0; c < ncomp; c++) {
          int a_, b_, c_, d_;
          neighbors(x + run, y, c, a_, b_, c_, d_);
          int xi = (int)px(x + run, y, c);
          int sg = sgn(b_ - a_);
          int err = t.compute_error(sg * (xi - b_));
          s.encode_run_interruption(*gw, s.rctx[0], err);
          px(x + run, y, c) = t.reconstruct(b_, err * sg);
        }
        s.dec_run();
        x += run + 1;
      } else {
        int run = s.decode_run_length(*gr, remaining);
        if (run < 0) run = remaining;
        for (int i = 0; i < run; i++)
          for (int c = 0; c < ncomp; c++) {
            int a_, b_, c_, d_;
            neighbors(x + i, y, c, a_, b_, c_, d_);
            px(x + i, y, c) = a_;
          }
        if (run >= remaining) { x += run; break; }
        for (int c = 0; c < ncomp; c++) {
          int a_, b_, c_, d_;
          neighbors(x + run, y, c, a_, b_, c_, d_);
          int sg = sgn(b_ - a_);
          int err = s.decode_run_interruption(*gr, s.rctx[0]);
          err = t.modulo_range(err * sg);
          px(x + run, y, c) = t.reconstruct(b_, err);
        }
        s.dec_run();
        x += run + 1;
      }
    }
    for (int c = 0; c < ncomp; c++) {
      prev_prev_first[c] = prev_first[c];
      prev_first[c] = (int)px(0, y, c);
    }
  }
}

}  // namespace jls

extern "C" {

// Encode a JPEG-LS scan (entropy bytes only, no markers).
// img: [h*w*comps] interleaved samples (modified: reconstruction).
// Returns byte length, or -1 on error.
// Encode one JPEG-LS scan. ilv: 2 = sample interleaved (multi-comp
// default), 1 = line interleaved, else single-component/planar.
int jls_encode_scan(int64_t* img, int w, int h, int comps, int maxval,
                    int near_, int reset, int t1, int t2, int t3,
                    int ilv, uint8_t* out, int cap) {
  if (comps < 1 || comps > 4) return -1;
  jls::Scan s;
  s.t = jls::Traits{maxval, near_, reset, t1, t2, t3};
  s.t.init();
  s.t.build_qlut();
  s.init();
  jls::GWriter gw;
  // worst case: limit <= 64 bits/sample plus 8/7 stuffing expansion
  static thread_local std::vector<uint8_t> scratch;
  size_t need = (size_t)w * h * comps * 10 + 1024;
  if (scratch.size() < need) scratch.resize(need);
  gw.buf = scratch.data();
  if (comps == 1)
    jls::code_component<true>(s, &gw, nullptr, img, w, h);
  else if (ilv == 1)
    jls::code_line_interleaved<true>(s, &gw, nullptr, img, w, h, comps);
  else
    jls::code_interleaved<true>(s, &gw, nullptr, img, w, h, comps);
  gw.finish();
  if ((int)gw.n > cap) return -1;
  memcpy(out, gw.buf, gw.n);
  return (int)gw.n;
}

// Decode a JPEG-LS scan. ilv: 0 = component-planar scans in sequence,
// 2 = sample interleaved. out: [h*w*comps] interleaved.
int jls_decode_scan(const uint8_t* data, int len, int w, int h, int comps,
                    int maxval, int near_, int reset, int t1, int t2, int t3,
                    int ilv, int64_t* out) {
  if (comps < 1 || comps > 4) return -1;
  jls::GReader gr{data, len};
  if (ilv == 1 && comps > 1) {
    jls::Scan s;
    s.t = jls::Traits{maxval, near_, reset, t1, t2, t3};
    s.t.init();
    s.t.build_qlut();
    s.init();
    memset(out, 0, (size_t)w * h * comps * sizeof(int64_t));
    jls::code_line_interleaved<false>(s, nullptr, &gr, out, w, h, comps);
    return 0;
  }
  if (comps == 1 || ilv == 0) {
    std::vector<int64_t> plane((size_t)w * h);
    for (int c = 0; c < comps; c++) {
      jls::Scan s;
      s.t = jls::Traits{maxval, near_, reset, t1, t2, t3};
      s.t.init();
  s.t.build_qlut();
      s.init();
      memset(plane.data(), 0, plane.size() * sizeof(int64_t));
      jls::code_component<false>(s, nullptr, &gr, plane.data(), w, h);
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
          out[((size_t)y * w + x) * comps + c] = plane[(size_t)y * w + x];
    }
    return 0;
  }
  jls::Scan s;
  s.t = jls::Traits{maxval, near_, reset, t1, t2, t3};
  s.t.init();
  s.t.build_qlut();
  s.init();
  memset(out, 0, (size_t)w * h * comps * sizeof(int64_t));
  jls::code_interleaved<false>(s, nullptr, &gr, out, w, h, comps);
  return 0;
}

}  // extern "C"

// ============================================================================
// Classic-JPEG scan decoders (baseline/extended sequential + lossless P14)
// — exact mirrors of codecs/jpeg_common.decode_scan and
// codecs/jpeg_lossless.decode's serial Huffman stage.
// Input is the DESTUFFED entropy byte array (utils/npbits.destuff_ff);
// restart boundaries byte-align and reset DC predictors.
// ============================================================================

namespace jpg {

struct BitRd {
  const uint8_t* data;   // caller guarantees >= 4 bytes of 0xFF padding
  long nbits;            // (reads beyond the stream see 1-bits)
  long pos = 0;
  std::vector<uint8_t> padded;  // owning storage when padding was added

  void init_padded(const uint8_t* src, long nbits_) {
    long n = (nbits_ + 7) >> 3;
    padded.resize((size_t)n + 4);
    memcpy(padded.data(), src, (size_t)n);
    memset(padded.data() + n, 0xFF, 4);
    data = padded.data();
    nbits = nbits_;
  }

  inline uint32_t win32(long p) const {
    long b = p >> 3;
    if (b >= (nbits + 7) >> 3) return 0xFFFFFFFFu;  // far past the end
    uint32_t v;
    memcpy(&v, data + b, 4);  // 4-byte 0xFF pad keeps this in bounds
    return __builtin_bswap32(v);
  }
  inline int peek16() const { return (win32(pos) >> (16 - (pos & 7))) & 0xFFFF; }
  inline int take(int n) {
    int v = (win32(pos) >> (32 - (pos & 7) - n)) & ((1 << n) - 1);
    pos += n;
    return v;
  }
  inline void skip(int n) { pos += n; }
  inline void align() { pos = (pos + 7) & ~7L; }
};

struct HuffLut {
  std::vector<int32_t> lut;  // (len<<8)|sym, 0 invalid
  bool valid = false;
  void build(const uint8_t* bits16, const uint8_t* vals, int nvals) {
    lut.assign(1 << 16, 0);
    int code = 0, k = 0;
    for (int length = 1; length <= 16; length++) {
      for (int i = 0; i < bits16[length - 1] && k < nvals; i++) {
        int sym = vals[k];
        long hi = (long)(code + 1) << (16 - length);
        if (hi > (1 << 16)) return;  // oversubscribed DHT: keep invalid
        long lo = (long)code << (16 - length);
        for (long j = lo; j < hi; j++) lut[j] = (length << 8) | sym;
        code++;
        k++;
      }
      code <<= 1;
    }
    valid = true;
  }
  inline int decode(BitRd& br, bool* ok) const {
    int e = lut[br.peek16()];
    if (e == 0) { *ok = false; return 0; }
    br.skip(e >> 8);
    return e & 0xFF;
  }
};

inline int receive_extend(int v, int s) {
  if (s == 0) return 0;
  if (v < (1 << (s - 1))) return v - (1 << s) + 1;
  return v;
}

}  // namespace jpg

extern "C" {

// Sequential-DCT scan decode (mirror of jpeg_common.decode_scan).
// tables: dc_bits/ac_bits are [4][16]; dc_vals/ac_vals are [4][256] with
// dc_nvals/ac_nvals counts; table slots without data have nvals 0.
// out: concatenated per-component zigzag blocks, comp c starting at
// out_offsets[c], laid out [mcu_rows*v*bpr][64] int32.
int jpg_decode_scan(const uint8_t* destuffed, long nbytes, int ncomp,
                    const int32_t* comp_h, const int32_t* comp_v,
                    const int32_t* comp_dc, const int32_t* comp_ac,
                    const int32_t* comp_bpr, int mcu_cols, int mcu_rows,
                    int restart,
                    const uint8_t* dc_bits, const uint8_t* dc_vals,
                    const int32_t* dc_nvals,
                    const uint8_t* ac_bits, const uint8_t* ac_vals,
                    const int32_t* ac_nvals,
                    int32_t* out, const int64_t* out_offsets) {
  jpg::BitRd br;
  br.init_padded(destuffed, nbytes * 8);
  jpg::HuffLut dct[4], act[4];
  for (int t = 0; t < 4; t++) {
    if (dc_nvals[t] > 0) dct[t].build(dc_bits + t * 16, dc_vals + t * 256,
                                      dc_nvals[t]);
    if (ac_nvals[t] > 0) act[t].build(ac_bits + t * 16, ac_vals + t * 256,
                                      ac_nvals[t]);
  }
  std::vector<int> dc_pred(ncomp, 0);
  long mcu_index = 0;
  bool ok = true;
  for (int my = 0; my < mcu_rows; my++)
    for (int mx = 0; mx < mcu_cols; mx++) {
      if (restart > 0 && mcu_index > 0 && mcu_index % restart == 0) {
        br.align();
        std::fill(dc_pred.begin(), dc_pred.end(), 0);
      }
      mcu_index++;
      for (int ci = 0; ci < ncomp; ci++) {
        // hostile streams can put any byte in the SOS table ids —
        // bound-check before indexing the 4-slot arrays
        if (comp_dc[ci] < 0 || comp_dc[ci] >= 4 ||
            comp_ac[ci] < 0 || comp_ac[ci] >= 4) return -2;
        const jpg::HuffLut& dtab = dct[comp_dc[ci]];
        const jpg::HuffLut& atab = act[comp_ac[ci]];
        if (!dtab.valid || !atab.valid) return -2;
        for (int bv = 0; bv < comp_v[ci]; bv++)
          for (int bh = 0; bh < comp_h[ci]; bh++) {
            int bx = mx * comp_h[ci] + bh;
            int by = my * comp_v[ci] + bv;
            int32_t coef[64] = {0};
            int s = dtab.decode(br, &ok);
            if (!ok) return -1;
            int diff = s ? jpg::receive_extend(br.take(s), s) : 0;
            dc_pred[ci] += diff;
            coef[0] = dc_pred[ci];
            int k = 1;
            while (k < 64) {
              int rs = atab.decode(br, &ok);
              if (!ok) return -1;
              int r = rs >> 4, sz = rs & 0xF;
              if (sz == 0) {
                if (r == 15) { k += 16; continue; }
                break;
              }
              k += r;
              if (k >= 64) return -1;
              coef[k] = jpg::receive_extend(br.take(sz), sz);
              k++;
            }
            if (bx < comp_bpr[ci]) {
              int64_t off = out_offsets[ci] +
                            ((int64_t)by * comp_bpr[ci] + bx) * 64;
              memcpy(out + off, coef, sizeof(coef));
            }
          }
      }
    }
  return 0;
}

// Lossless P14 scan decode (mirror of jpeg_lossless.decode's Huffman
// stage): per pixel, per component: category + extend; cat 16 => -32768.
// tables: [4][16]+[4][256]; comp_tid selects the table per component.
int jpg_lossless_decode_scan(const uint8_t* destuffed, long nbytes,
                             int w, int h, int ncomp,
                             const int32_t* comp_tid,
                             const uint8_t* bits, const uint8_t* vals,
                             const int32_t* nvals, int32_t* diffs) {
  jpg::BitRd br;
  br.init_padded(destuffed, nbytes * 8);
  jpg::HuffLut tabs[4];
  for (int t = 0; t < 4; t++)
    if (nvals[t] > 0) tabs[t].build(bits + t * 16, vals + t * 256, nvals[t]);
  for (int c = 0; c < ncomp; c++)  // hostile SOS table ids (see above)
    if (comp_tid[c] < 0 || comp_tid[c] >= 4) return -2;
  bool ok = true;
  long n = (long)w * h * ncomp;
  for (long i = 0; i < n; i++) {
    const jpg::HuffLut& tab = tabs[comp_tid[i % ncomp]];
    if (!tab.valid) return -2;
    int cat = tab.decode(br, &ok);
    if (!ok) return -1;
    if (cat == 0) { diffs[i] = 0; continue; }
    if (cat == 16) { diffs[i] = -32768; continue; }
    diffs[i] = jpg::receive_extend(br.take(cat), cat);
  }
  return 0;
}

}  // extern "C"

// ===========================================================================
// HTJ2K cleanup-pass coder (ISO/IEC 15444-15, OpenJPH-parity) — native
// mirror of entropy/htcleanup.py. LUTs are passed in from Python
// (codecs/ht_tables.py stays the single source of truth).
// ===========================================================================

namespace htj2k {

static const int MEL_E[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

// The three segment writers append to caller-provided scratch (raw
// pointer + count) — per-byte std::vector::push_back was the hot spot
// of dense HT encodes, and the capacities are bounded by construction
// (see the cap math at ht_scratch below).
struct MELWriter {
  uint8_t* buf = nullptr;
  long n = 0;
  int tmp = 0, rem = 8, run = 0, k = 0, threshold = 1;
  inline void emit(int v) {
    tmp = ((tmp << 1) | (v & 1)) & 0xFF;
    if (--rem == 0) {
      buf[n++] = (uint8_t)tmp;
      rem = tmp == 0xFF ? 7 : 8;
      tmp = 0;
    }
  }
  inline void encode(bool bit) {
    if (!bit) {
      if (++run >= threshold) {
        emit(1);
        run = 0;
        if (k < 12) k++;
        threshold = 1 << MEL_E[k];
      }
      return;
    }
    emit(0);
    for (int t = MEL_E[k] - 1; t >= 0; t--) emit((run >> t) & 1);
    run = 0;
    if (k > 0) k--;
    threshold = 1 << MEL_E[k];
  }
};

struct VLCWriter {
  uint8_t* buf = nullptr;
  long n = 0;
  int used = 4, tmp = 0xF;
  bool last_gt_8f = true;
  inline void start() { buf[n++] = 0xFF; }
  inline void encode(int cwd, int nb) {
    while (nb > 0) {
      int avail = 8 - (last_gt_8f ? 1 : 0) - used;
      int t = avail < nb ? avail : nb;
      tmp |= (cwd & ((1 << t) - 1)) << used;
      used += t;
      avail -= t;
      nb -= t;
      cwd >>= t;
      if (avail == 0) {
        if (last_gt_8f && tmp != 0x7F) {
          last_gt_8f = false;
          continue;
        }
        buf[n++] = (uint8_t)(tmp & 0xFF);
        last_gt_8f = tmp > 0x8F;
        tmp = 0;
        used = 0;
      }
    }
  }
};

struct MagSgnWriter {
  uint8_t* buf = nullptr;
  long n = 0;
  int maxbits = 8, used = 0;
  uint64_t tmp = 0;
  inline void encode(uint64_t cwd, int nb) {
    while (nb > 0) {
      int t = maxbits - used < nb ? maxbits - used : nb;
      tmp |= (cwd & ((1ull << t) - 1)) << used;
      used += t;
      cwd >>= t;
      nb -= t;
      if (used >= maxbits) {
        uint8_t b = (uint8_t)(tmp & 0xFF);
        buf[n++] = b;
        maxbits = b == 0xFF ? 7 : 8;
        tmp = 0;
        used = 0;
      }
    }
  }
  void terminate() {
    if (used) {
      int t = maxbits - used;
      tmp |= (uint64_t)(0xFF & ((1 << t) - 1)) << used;
      if ((tmp & 0xFF) != 0xFF) buf[n++] = (uint8_t)(tmp & 0xFF);
    } else if (maxbits == 7 && n > 0) {
      n--;
    }
  }
};

inline void uvlc_code(int code, int* pre, int* pre_len, int* suf,
                      int* suf_len) {
  if (code <= 0) { *pre = 0; *pre_len = 0; *suf = 0; *suf_len = 0; return; }
  if (code == 1) { *pre = 1; *pre_len = 1; *suf = 0; *suf_len = 0; return; }
  if (code == 2) { *pre = 2; *pre_len = 2; *suf = 0; *suf_len = 0; return; }
  if (code <= 4) { *pre = 4; *pre_len = 3; *suf = code - 3; *suf_len = 1;
                   return; }
  *pre = 0; *pre_len = 3; *suf = code - 5; *suf_len = 5;
}

struct Quad {
  int rho = 0, eqmax = 0;
  int eq[4] = {0, 0, 0, 0};
  uint32_t s[4] = {0, 0, 0, 0};
};

struct HTEnc {
  const uint32_t* cb;
  int w, h, p;
  const int32_t *lut0, *lut1;
  MELWriter mel;
  VLCWriter vlc;
  MagSgnWriter ms;
  int *e_val = nullptr, *cx_val = nullptr;

  inline void sample(int x, int y, int idx, Quad& q) {
    if (x >= w || y >= h) return;
    uint32_t t = cb[(long)y * w + x];
    uint32_t val = ((t + t) & 0xFFFFFFFFu) >> p;
    val &= ~1u;
    if (val == 0) return;
    q.rho |= 1 << idx;
    val -= 1;
    int e = val ? 32 - __builtin_clz(val) : 0;
    q.eq[idx] = e;
    if (e > q.eqmax) q.eqmax = e;
    val -= 1;
    q.s[idx] = val + (t >> 31);
  }
  inline void sample_t(uint32_t t, int idx, Quad& q) {
    uint32_t val = ((t + t) & 0xFFFFFFFFu) >> p;
    val &= ~1u;
    if (val == 0) return;
    q.rho |= 1 << idx;
    val -= 1;
    int e = val ? 32 - __builtin_clz(val) : 0;
    q.eq[idx] = e;
    if (e > q.eqmax) q.eqmax = e;
    val -= 1;
    q.s[idx] = val + (t >> 31);
  }
  inline Quad quad(int x, int y) {
    if (x + 1 < w && y + 1 < h) {
      // interior: one base address, no per-sample bounds checks
      const uint32_t* b = cb + (long)y * w + x;
      Quad q;
      sample_t(b[0], 0, q);
      sample_t(b[w], 1, q);
      sample_t(b[1], 2, q);
      sample_t(b[w + 1], 3, q);
      return q;
    }
    Quad q;
    sample(x, y, 0, q);
    sample(x, y + 1, 1, q);
    sample(x + 1, y, 2, q);
    sample(x + 1, y + 1, 3, q);
    return q;
  }
  static inline int eps_of(const Quad& q, int u) {
    if (u <= 0) return 0;
    int e = 0;
    for (int i = 0; i < 4; i++)
      if (q.eq[i] == q.eqmax) e |= 1 << i;
    return e;
  }
  inline int tuple_of(bool initial, int cq, int rho, int eps) {
    if (rho == 0 && cq == 0) return 0;
    const int32_t* lut = initial ? lut0 : lut1;
    return lut[(cq << 8) | (rho << 4) | eps];
  }
  inline void magsgn(const Quad& q, int uq, int tup) {
    // batch the four samples' bits into one writer call per <=64-bit
    // chunk — the bit sequence is identical to per-sample encodes
    uint64_t acc = 0;
    int nb = 0;
    for (int i = 0; i < 4; i++) {
      if (!(q.rho & (1 << i))) continue;
      int m = uq - ((tup >> i) & 1);
      if (m < 0) m = 0;
      if (nb + m > 64) { ms.encode(acc, nb); acc = 0; nb = 0; }
      acc |= (uint64_t)(q.s[i] & ((m >= 64) ? ~0ull : ((1ull << m) - 1)))
             << nb;
      nb += m;
    }
    if (nb) ms.encode(acc, nb);
  }
  // the four UVLC fields always total <=16 bits — pack them into one
  // writer call (identical bit sequence: p0, p1, s0, s1 LSB-first)
  inline void uvlc_initial(int u0, int u1) {
    int p0, l0, s0, sl0, p1, l1, s1, sl1;
    if (u0 > 2 && u1 > 2) {
      uvlc_code(u0 - 2, &p0, &l0, &s0, &sl0);
      uvlc_code(u1 - 2, &p1, &l1, &s1, &sl1);
    } else if (u0 > 2 && u1 > 0) {
      uvlc_code(u0, &p0, &l0, &s0, &sl0);
      p1 = u1 - 1; l1 = 1; s1 = 0; sl1 = 0;
    } else {
      uvlc_code(u0, &p0, &l0, &s0, &sl0);
      uvlc_code(u1, &p1, &l1, &s1, &sl1);
    }
    vlc.encode(p0 | (p1 << l0) | (s0 << (l0 + l1)) |
                   (s1 << (l0 + l1 + sl0)),
               l0 + l1 + sl0 + sl1);
  }
  inline void uvlc_noninitial(int u0, int u1) {
    int p0, l0, s0, sl0, p1, l1, s1, sl1;
    uvlc_code(u0, &p0, &l0, &s0, &sl0);
    uvlc_code(u1, &p1, &l1, &s1, &sl1);
    vlc.encode(p0 | (p1 << l0) | (s0 << (l0 + l1)) |
                   (s1 << (l0 + l1 + sl0)),
               l0 + l1 + sl0 + sl1);
  }

  void rows(bool initial) {
    for (int y = initial ? 0 : 2; y < (initial ? 1 : h); y += 2) {
      int lep = 0, lcxp = 0, cq0 = 0, max_e = 0, cq1 = 0;
      if (initial) {
        e_val[0] = 0;
        cx_val[0] = 0;
      } else {
        max_e = (e_val[0] > e_val[1] ? e_val[0] : e_val[1]) - 1;
        e_val[0] = 0;
        cq0 = cx_val[0] + (cx_val[1] << 2);
        cx_val[0] = 0;
      }
      for (int x = 0; x < w; x += 4) {
        Quad q0 = quad(x, y);
        int rho0 = q0.rho, uq0, u0;
        if (initial) {
          uq0 = q0.eqmax > 1 ? q0.eqmax : 1;
          u0 = uq0 - 1;
        } else {
          int kappa = (rho0 & (rho0 - 1)) ? (max_e > 1 ? max_e : 1) : 1;
          uq0 = q0.eqmax > kappa ? q0.eqmax : kappa;
          u0 = uq0 - kappa;
        }
        int eps0 = eps_of(q0, u0);
        if (q0.eq[1] > e_val[lep]) e_val[lep] = q0.eq[1];
        lep++;
        if (!initial)
          max_e = (e_val[lep] > e_val[lep + 1] ? e_val[lep]
                                               : e_val[lep + 1]) - 1;
        e_val[lep] = q0.eq[3];
        cx_val[lcxp] |= (rho0 & 2) >> 1;
        lcxp++;
        if (!initial) cq1 = cx_val[lcxp] + (cx_val[lcxp + 1] << 2);
        cx_val[lcxp] = (rho0 & 8) >> 3;

        int tup0 = tuple_of(initial, cq0, rho0, eps0);
        vlc.encode(tup0 >> 8, (tup0 >> 4) & 7);
        if (cq0 == 0) mel.encode(rho0 != 0);
        magsgn(q0, uq0, tup0);

        int u1 = 0, rho1 = 0;
        if (x + 2 < w) {
          Quad q1 = quad(x + 2, y);
          rho1 = q1.rho;
          int uq1;
          if (initial) {
            cq1 = (rho0 >> 1) | (rho0 & 1);
            uq1 = q1.eqmax > 1 ? q1.eqmax : 1;
            u1 = uq1 - 1;
          } else {
            cq1 |= ((rho0 & 4) >> 1) | ((rho0 & 8) >> 2);
            int kappa = (rho1 & (rho1 - 1)) ? (max_e > 1 ? max_e : 1) : 1;
            uq1 = q1.eqmax > kappa ? q1.eqmax : kappa;
            u1 = uq1 - kappa;
          }
          int eps1 = eps_of(q1, u1);
          if (q1.eq[1] > e_val[lep]) e_val[lep] = q1.eq[1];
          lep++;
          if (!initial)
            max_e = (e_val[lep] > e_val[lep + 1] ? e_val[lep]
                                                 : e_val[lep + 1]) - 1;
          e_val[lep] = q1.eq[3];
          cx_val[lcxp] |= (rho1 & 2) >> 1;
          lcxp++;
          if (!initial) cq0 = cx_val[lcxp] + (cx_val[lcxp + 1] << 2);
          cx_val[lcxp] = (rho1 & 8) >> 3;

          int tup1 = tuple_of(initial, cq1, rho1, eps1);
          vlc.encode(tup1 >> 8, (tup1 >> 4) & 7);
          if (cq1 == 0) mel.encode(rho1 != 0);
          magsgn(q1, uq1, tup1);
        }
        if (initial) {
          if (u0 > 0 && u1 > 0) mel.encode((u0 < u1 ? u0 : u1) > 2);
          uvlc_initial(u0, u1);
          cq0 = (rho1 >> 1) | (rho1 & 1);
        } else {
          uvlc_noninitial(u0, u1);
          cq0 |= ((rho1 & 4) >> 1) | ((rho1 & 8) >> 2);
        }
      }
      if (initial) e_val[lep + 1] = 0;
    }
  }
};

struct MELReader {
  const uint8_t* data;
  long len, pos = 0, size;
  bool unstuff = false;
  int k = 0;
  uint64_t bitbuf = 0;
  int nbits = 0;
  MELReader(const uint8_t* d, long n) : data(d), len(n), size(n - 1) {}
  inline int read_bit() {
    if (nbits == 0) {
      if (size <= 0) return 1;
      int d = 0xFF;
      if (pos < len) {
        d = data[pos++];
        if (size == 1) d |= 0x0F;
        size--;
      }
      int valid = unstuff ? 7 : 8;
      bitbuf = (uint64_t)(d & ((1 << valid) - 1));
      nbits = valid;
      unstuff = d == 0xFF;
    }
    nbits--;
    return (int)((bitbuf >> nbits) & 1);
  }
  int get_run() {
    int e = MEL_E[k];
    if (read_bit() == 1) {
      int run = ((1 << e) - 1) << 1;
      if (k < 12) k++;
      return run;
    }
    int run = 0;
    for (int i = 0; i < e; i++) run = (run << 1) | read_bit();
    if (k > 0) k--;
    return (run << 1) + 1;
  }
};

struct VLCReader {
  const uint8_t* data;  // reversed segment
  long len, pos = 1;
  uint64_t bitpool = 0;
  int nbits = 0;
  bool unstuff = false, first = true;
  VLCReader(const uint8_t* d, long n) : data(d), len(n) {}
  inline void load_byte() {
    int b = pos < len ? data[pos++] : 0xFF;
    int n, bits;
    if (first) {
      first = false;
      int nib = b >> 4;
      n = 4 - (((nib & 7) == 7) ? 1 : 0);
      bits = nib & ((1 << n) - 1);
      unstuff = (b | 0x0F) > 0x8F;
    } else {
      n = 8;
      if (unstuff && (b & 0x7F) == 0x7F) n = 7;
      bits = b & ((1 << n) - 1);
      unstuff = b > 0x8F;
    }
    bitpool |= (uint64_t)bits << nbits;
    nbits += n;
  }
  inline int peek(int n) {
    while (nbits < n) load_byte();
    return (int)(bitpool & ((1ull << n) - 1));
  }
  inline void advance(int n) {
    while (nbits < n) load_byte();
    bitpool >>= n;
    nbits -= n;
  }
  inline int read_bits(int n) {
    if (!n) return 0;
    int v = peek(n);
    advance(n);
    return v;
  }
};

struct MagSgnReader {
  const uint8_t* data;
  long len, pos = 0;
  uint64_t bitpool = 0;
  int nbits = 0;
  bool prev_ff = false;
  MagSgnReader(const uint8_t* d, long n) : data(d), len(n) {}
  // n <= 56 (refill appends 7-8 bits while nbits < n, so nbits stays
  // < 64); LSB-first — splitting low bits off one wide fetch consumes
  // identically to several narrow ones
  inline uint64_t fetch_wide(int n) {
    while (nbits < n) {
      int b = pos < len ? data[pos++] : 0xFF;
      int valid = prev_ff ? 7 : 8;
      bitpool |= (uint64_t)(b & ((1 << valid) - 1)) << nbits;
      nbits += valid;
      prev_ff = b == 0xFF;
    }
    uint64_t v = n ? (bitpool & ((1ull << n) - 1)) : 0;
    bitpool >>= n;
    nbits -= n;
    return v;
  }
  inline uint32_t fetch(int n) { return (uint32_t)fetch_wide(n); }
};

}  // namespace htj2k

// Encode one HT cleanup codeblock (templated over the source sample
// type so the batched int32 entry skips the Python-side widening
// copy). Returns byte count, 0 for an all-zero block, -1 on error.
// Reused per-thread scratch for HT encodes: the magnitude|sign plane
// plus the three segment buffers. Segment capacity math (per sample):
// MagSgn bits <= 32 per coded sample (kmax < 31) -> <5 bytes incl.
// 8/7 stuffing expansion; VLC <= 36 bits per quad-PAIR (two 7-bit
// tuples + two 3+5-bit u_q codes + slack) -> <1 byte/sample; MEL <= 6
// bits per quad -> <1 byte/sample. wh*6 + 64 bounds each comfortably.
struct HTEncScratch {
  std::vector<uint32_t> cb;
  std::vector<int> e_val, cx_val;
  std::vector<uint8_t> mel, vlc, ms;
  void prepare(long wh, int npairs) {
    if ((long)cb.size() < wh) cb.resize(wh);
    if ((int)e_val.size() < npairs + 2) {
      e_val.resize(npairs + 2);
      cx_val.resize(npairs + 2);
    }
    long cap = wh * 6 + 64;
    if ((long)ms.size() < cap) {
      ms.resize(cap);
      vlc.resize(cap);
      mel.resize(cap);
    }
  }
};

template <typename ST>
static long ht_cleanup_encode_impl(const ST* data, int w, int h, int kmax,
                                   const int32_t* enc_lut0,
                                   const int32_t* enc_lut1, uint8_t* out,
                                   long out_cap) {
  using namespace htj2k;
  if (kmax <= 0 || kmax >= 31) return -1;
  int shift = 31 - kmax;
  static thread_local HTEncScratch scratch;
  int npairs = (w + 1) / 2 + 2;
  scratch.prepare((long)w * h, npairs);
  uint32_t* cb = scratch.cb.data();
  uint64_t maxmag = 0;
  for (long i = 0; i < (long)w * h; i++) {
    int64_t v = data[i];
    uint64_t mag = (uint64_t)(v < 0 ? -v : v) << shift;
    if (mag > maxmag) maxmag = mag;
    cb[i] = (uint32_t)((v < 0 ? 0x80000000u : 0u) | (mag & 0x7FFFFFFFu));
  }
  if (maxmag < (1ull << shift)) return 0;

  HTEnc enc;
  enc.cb = cb;
  enc.w = w;
  enc.h = h;
  enc.p = 30 - (kmax - 1);
  enc.lut0 = enc_lut0;
  enc.lut1 = enc_lut1;
  enc.e_val = scratch.e_val.data();
  enc.cx_val = scratch.cx_val.data();
  memset(enc.e_val, 0, sizeof(int) * (npairs + 2));
  memset(enc.cx_val, 0, sizeof(int) * (npairs + 2));
  enc.mel.buf = scratch.mel.data();
  enc.vlc.buf = scratch.vlc.data();
  enc.ms.buf = scratch.ms.data();
  enc.vlc.start();
  enc.rows(true);
  enc.rows(false);

  // terminate: fuse trailing MEL/VLC bytes when possible
  MELWriter& mel = enc.mel;
  VLCWriter& vlc = enc.vlc;
  if (mel.run > 0) mel.emit(1);
  int mel_tmp = (mel.tmp << mel.rem) & 0xFF;
  int mel_mask = (0xFF << mel.rem) & 0xFF;
  int vlc_mask = vlc.used > 0 ? (0xFF >> (8 - vlc.used)) : 0;
  if ((mel_mask | vlc_mask) != 0) {
    int fuse = mel_tmp | vlc.tmp;
    if (((((fuse ^ mel_tmp) & mel_mask) |
          ((fuse ^ vlc.tmp) & vlc_mask)) == 0) &&
        fuse != 0xFF && vlc.n > 1) {
      mel.buf[mel.n++] = (uint8_t)(fuse & 0xFF);
    } else {
      mel.buf[mel.n++] = (uint8_t)mel_tmp;
      vlc.buf[vlc.n++] = (uint8_t)(vlc.tmp & 0xFF);
    }
  }
  enc.ms.terminate();

  long scup = mel.n + vlc.n;
  if (scup == 0) return -1;
  long total = enc.ms.n + scup;
  if (total > out_cap || total < 2) return -1;
  long o = 0;
  memcpy(out + o, enc.ms.buf, enc.ms.n);
  o += enc.ms.n;
  memcpy(out + o, mel.buf, mel.n);
  o += mel.n;
  // VLC segment: bytes after index 0 reversed, then byte 0 (0xFF) last
  for (long i = vlc.n - 1; i >= 1; i--) out[o++] = vlc.buf[i];
  out[o++] = vlc.buf[0];
  out[o - 1] = (uint8_t)((scup >> 4) & 0xFF);
  out[o - 2] = (uint8_t)((out[o - 2] & 0xF0) | (scup & 0x0F));
  return o;
}

extern "C" {

// Encode one HT cleanup codeblock. data: int64 [h*w]. Returns byte
// count, 0 for an all-zero block, -1 on error/overflow.
long ht_cleanup_encode(const int64_t* data, int w, int h, int kmax,
                       const int32_t* enc_lut0, const int32_t* enc_lut1,
                       uint8_t* out, long out_cap) {
  return ht_cleanup_encode_impl(data, w, h, kmax, enc_lut0, enc_lut1, out,
                                out_cap);
}

// Batched HT cleanup encode: every HT code-block of a tile in one
// call, int32 source (no widening copy). Blocks concatenated at
// sample offsets `offsets` (nb+1); streams land concatenated in `out`
// with byte offsets in `out_offsets` (nb+1). status[i] = per-block
// byte count, 0 for all-zero, -1 on error (caller falls back).
long ht_cleanup_encode_blocks(const int32_t* src, const int64_t* offsets,
                              const int32_t* ws, const int32_t* hs,
                              const int32_t* kmaxs, int nb,
                              const int32_t* enc_lut0,
                              const int32_t* enc_lut1, uint8_t* out,
                              long out_cap, int64_t* out_offsets,
                              int32_t* status) {
  int nthreads = batch_threads(nb);
  if (nthreads > 1) {
    // parallel: per-block temps sized to the caller's bound
    // (native/__init__.py: size*8 + 4096 per block) + in-order concat;
    // per-block -1 status (caller falls back on that block) exactly as
    // the serial loop reports it.
    std::vector<int64_t> toff((size_t)nb + 1, 0);
    for (int i = 0; i < nb; i++)
      toff[i + 1] = toff[i] + (int64_t)ws[i] * hs[i] * 8 + 4096;
    std::vector<uint8_t> tmp((size_t)toff[nb]);
    parallel_blocks(nb, nthreads, [&](int i) {
      long n = ht_cleanup_encode_impl(src + offsets[i], ws[i], hs[i],
                                      kmaxs[i], enc_lut0, enc_lut1,
                                      tmp.data() + toff[i],
                                      toff[i + 1] - toff[i]);
      status[i] = (int32_t)n;
    });
    long o = 0;
    out_offsets[0] = 0;
    for (int i = 0; i < nb; i++) {
      long n = status[i];
      if (n > 0) {
        if (o + n > out_cap) {  // caller's global bound — mark failed
          status[i] = -1;
        } else {
          memcpy(out + o, tmp.data() + toff[i], (size_t)n);
          o += n;
        }
      }
      out_offsets[i + 1] = o;
    }
    return o;
  }
  long o = 0;
  out_offsets[0] = 0;
  for (int i = 0; i < nb; i++) {
    long n = ht_cleanup_encode_impl(src + offsets[i], ws[i], hs[i],
                                    kmaxs[i], enc_lut0, enc_lut1, out + o,
                                    out_cap - o);
    status[i] = (int32_t)n;
    if (n > 0) o += n;
    out_offsets[i + 1] = o;
  }
  return o;
}

}  // pause extern "C" for the templated decode impl

// Reused per-thread scratch for HT decodes (mirror of HTEncScratch:
// the per-block vector allocations were measurable on dense tiles).
struct HTDecScratch {
  std::vector<uint8_t> rev;
  std::vector<int> inf_all, u_all, rhos;
  std::vector<uint32_t> out32, vn;
};

// Decode one HT cleanup codeblock into out (int64 [h*w] from the
// scalar ABI, int32 from the batched one). Returns 0, or a negative
// error code (-1 args, -2 stream, -3 U_q bound).
template <typename OT>
static int ht_cleanup_decode_impl(const uint8_t* cbk, long n, int w, int h,
                                  int kmax, int missing,
                                  const int32_t* dec_lut0,
                                  const int32_t* dec_lut1, OT* out_data) {
  using namespace htj2k;
  memset(out_data, 0, sizeof(OT) * (size_t)w * h);
  if (n == 0) return 0;
  if (kmax <= 0 || missing < 0 || missing >= 30) return -1;
  if (n < 2) return -2;
  long scup = ((long)cbk[n - 1] << 4) | (cbk[n - 2] & 0x0F);
  if (scup < 2 || scup > n) return -2;
  const uint8_t* magsgn = cbk;
  long ms_len = n - scup;
  const uint8_t* cleanup = cbk + ms_len;

  int p = 30 - missing;
  MELReader mel(cleanup, scup);
  static thread_local HTDecScratch sc;
  if ((long)sc.rev.size() < scup) sc.rev.resize(scup);
  uint8_t* rev = sc.rev.data();
  for (long i = 0; i < scup; i++) rev[i] = cleanup[scup - 1 - i];
  VLCReader vlc(rev, scup);
  int run = mel.get_run();

  int nq = (w + 1) / 2;
  int nrows = (h + 1) / 2;
  // per quad per row: entry (info) and u
  if ((long)sc.inf_all.size() < (long)nrows * nq) {
    sc.inf_all.resize((size_t)nrows * nq);
    sc.u_all.resize((size_t)nrows * nq);
  }
  if ((int)sc.rhos.size() < 2 * nq) sc.rhos.resize(2 * nq);
  int* inf_all = sc.inf_all.data();
  int* u_all = sc.u_all.data();
  int* rhos_prev = sc.rhos.data();
  int* rhos_cur = rhos_prev + nq;
  memset(rhos_prev, 0, sizeof(int) * 2 * (size_t)nq);

  for (int row = 0; row < nrows; row++) {
    bool initial = row == 0;
    const int32_t* lut = initial ? dec_lut0 : dec_lut1;
    int cq = 0;
    for (int qx = 0; qx < nq; qx += 2) {
      int entries[2] = {0, 0};
      int rhopair[2] = {0, 0};
      for (int k2 = 0; k2 < 2; k2++) {
        if (qx + k2 >= nq) continue;
        if (!initial) {
          // causal context from previous row + west quad
          int qidx = qx + k2;
          cq = 0;
          if (qidx > 0) {
            int rw = rhos_cur[qidx - 1];
            cq |= ((rw & 4) >> 1) | ((rw & 8) >> 2);
          }
          int r_above = qidx < nq ? rhos_prev[qidx] : 0;
          int nw = qidx > 0 ? rhos_prev[qidx - 1] : 0;
          int ne = qidx + 1 < nq ? rhos_prev[qidx + 1] : 0;
          int c_nw = (nw & 8) >> 3;
          int c_n_sw = (r_above & 2) >> 1;
          int c_n_se = (r_above & 8) >> 3;
          int c_ne = (ne & 2) >> 1;
          cq |= (c_nw | c_n_sw);
          cq |= (c_n_se | c_ne) << 2;
        }
        int e = lut[(cq << 7) | vlc.peek(7)];
        if (cq == 0) {
          run -= 2;
          if (run != -1) e = 0;
          if (run < 0) run = mel.get_run();
        }
        vlc.advance(e & 0x7);
        int rho = (e >> 4) & 0xF;
        rhos_cur[qx + k2] = rho;
        entries[k2] = e;
        rhopair[k2] = rho;
        if (initial) cq = (rho >> 1) | (rho & 1);
      }
      bool u0_off = (entries[0] & 0x8) != 0;
      bool u1_off = (entries[1] & 0x8) != 0;
      int u0 = 0, u1 = 0;
      bool mel_event = false, have_event = false;
      if (initial && u0_off && u1_off) {
        run -= 2;
        mel_event = run == -1;
        have_event = true;
        if (run < 0) run = mel.get_run();
      }
      auto prefix = [&]() -> int {
        // one 3-bit peek replaces up to three refill-checked single-bit
        // reads; consumption is identical (stop at the first 1)
        int w3 = vlc.peek(3);
        if (w3 & 1) { vlc.advance(1); return 1; }
        if (w3 & 2) { vlc.advance(2); return 2; }
        vlc.advance(3);
        return (w3 & 4) ? 3 : 5;
      };
      auto suffix = [&](int cls) -> int {
        if (cls == 1) return 1;
        if (cls == 2) return 2;
        if (cls == 3) return 3 + vlc.read_bits(1);
        return 5 + vlc.read_bits(5);
      };
      if (initial && u0_off && u1_off) {
        if (have_event && mel_event) {
          int c0 = prefix();
          int c1 = prefix();
          u0 = suffix(c0) + 2;
          u1 = suffix(c1) + 2;
        } else {
          int c0 = prefix();
          if (c0 >= 3) {
            u1 = vlc.read_bits(1) + 1;
            u0 = suffix(c0);
          } else {
            int c1 = prefix();
            u0 = suffix(c0);
            u1 = suffix(c1);
          }
        }
      } else {
        int c0 = u0_off ? prefix() : 0;
        int c1 = u1_off ? prefix() : 0;
        if (u0_off) u0 = suffix(c0);
        if (u1_off) u1 = suffix(c1);
      }
      inf_all[(size_t)row * nq + qx] = entries[0];
      u_all[(size_t)row * nq + qx] = u0;
      if (qx + 1 < nq) {
        inf_all[(size_t)row * nq + qx + 1] = entries[1];
        u_all[(size_t)row * nq + qx + 1] = u1;
      }
    }
    std::swap(rhos_prev, rhos_cur);
    memset(rhos_cur, 0, sizeof(int) * (size_t)nq);
  }

  // MagSgn stage
  int mmsbp2 = missing + 2;
  MagSgnReader ms(magsgn, ms_len);
  if ((long)sc.out32.size() < (long)h * w) sc.out32.resize((size_t)h * w);
  uint32_t* out32 = sc.out32.data();
  if ((int)sc.vn.size() < 2 * (nq + 2)) sc.vn.resize(2 * (nq + 2));
  uint32_t* vn_prev = sc.vn.data();
  uint32_t* vn_cur = vn_prev + (nq + 2);
  memset(vn_prev, 0, sizeof(uint32_t) * (size_t)(nq + 2));
  for (int row = 0; row < nrows; row++) {
    int y = row * 2;
    memset(vn_cur, 0, sizeof(uint32_t) * (size_t)(nq + 2));
    uint32_t prev_vn = 0;
    for (int qi = 0; qi < nq; qi++) {
      int inf = inf_all[(size_t)row * nq + qi];
      int u = u_all[(size_t)row * nq + qi];
      int x = qi * 2;
      int uq;
      if (row == 0) {
        uq = 1 + u;
      } else {
        int gamma = (inf & 0xF0) & ((inf & 0xF0) - 0x10);
        uint32_t vv = (vn_prev[qi] | vn_prev[qi + 1]) | 2u;
        int emax = 31 - __builtin_clz(vv);
        int kappa = gamma ? emax : 1;
        uq = u + kappa;
      }
      if (uq > mmsbp2) return -3;
      uint32_t vals[4] = {0, 0, 0, 0};
      uint32_t vns[4] = {0, 0, 0, 0};
      // one batched fetch for the quad's MagSgn bits (LSB-first stream:
      // splitting the low bits off a single fetch consumes identically
      // to four per-sample fetches). The reader's refill supports up to
      // 56 bits per call; deeper quads fall back to per-sample fetches.
      int mns[4];
      int total = 0;
      for (int bit = 0; bit < 4; bit++) {
        mns[bit] = (inf & (1 << (4 + bit)))
                       ? uq - ((inf >> (12 + bit)) & 1)
                       : -1;
        if (mns[bit] > 0) total += mns[bit];
      }
      uint64_t pool = 0;
      int have = 0;
      if (total <= 56) { pool = ms.fetch_wide(total); have = total; }
      for (int bit = 0; bit < 4; bit++) {
        if (mns[bit] < 0) continue;
        int mn = mns[bit];
        uint32_t msval;
        if (have >= mn) {
          msval = mn ? (uint32_t)(pool & ((mn >= 32)
                                              ? 0xFFFFFFFFu
                                              : ((1u << mn) - 1)))
                     : 0;
          pool >>= mn;
          have -= mn;
        } else {
          msval = ms.fetch(mn);
        }
        uint32_t val = (msval & 1) << 31;
        uint32_t vn = mn ? (msval & ((1u << mn) - 1)) : 0;
        vn |= ((uint32_t)(inf >> (8 + bit)) & 1) << mn;
        vn |= 1;
        val |= ((vn + 2) << (p - 1)) & 0x7FFFFFFFu;
        vals[bit] = val;
        vns[bit] = vn;
      }
      if (x < w) {
        out32[(size_t)y * w + x] = vals[0];
        if (y + 1 < h) out32[(size_t)(y + 1) * w + x] = vals[1];
      }
      if (x + 1 < w) {
        out32[(size_t)y * w + x + 1] = vals[2];
        if (y + 1 < h) out32[(size_t)(y + 1) * w + x + 1] = vals[3];
      }
      vn_cur[qi] = prev_vn | vns[1];
      prev_vn = vns[3];
    }
    vn_cur[nq] = prev_vn;
    std::swap(vn_prev, vn_cur);
  }

  int shift = 31 - kmax;
  for (long i = 0; i < (long)w * h; i++) {
    uint32_t v = out32[i];
    int64_t mag = (int64_t)((v & 0x7FFFFFFFu) >> shift);
    out_data[i] = (OT)((v & 0x80000000u) ? -mag : mag);
  }
  return 0;
}

extern "C" {

int ht_cleanup_decode(const uint8_t* cbk, long n, int w, int h, int kmax,
                      int missing, const int32_t* dec_lut0,
                      const int32_t* dec_lut1, int64_t* out_data) {
  return ht_cleanup_decode_impl(cbk, n, w, h, kmax, missing, dec_lut0,
                                dec_lut1, out_data);
}

// Batched HT cleanup decode: int32 outputs concatenated at sample
// offsets `out_offsets` (nb+1, w*h prefix sums); streams concatenated
// at byte offsets `offs`. status[i] = the per-block ht_cleanup_decode
// code (0 ok); failed blocks stay zeroed and the caller re-runs them
// through the scalar path for exact error semantics.
int ht_cleanup_decode_blocks(const uint8_t* data, const int64_t* offs,
                             const int32_t* ws, const int32_t* hs,
                             const int32_t* kmaxs,
                             const int32_t* missings, int nb,
                             const int32_t* dec_lut0,
                             const int32_t* dec_lut1, int32_t* out,
                             const int64_t* out_offsets, int32_t* status) {
  // blocks decode into disjoint out/status slots — directly parallel
  parallel_blocks(nb, batch_threads(nb), [&](int i) {
    int32_t* dst = out + out_offsets[i];
    status[i] = ht_cleanup_decode_impl(data + offs[i],
                                       (long)(offs[i + 1] - offs[i]), ws[i],
                                       hs[i], kmaxs[i], missings[i],
                                       dec_lut0, dec_lut1, dst);
    if (status[i] != 0)
      memset(dst, 0, (size_t)ws[i] * hs[i] * sizeof(int32_t));
  });
  return 0;
}

}  // extern "C"

// ============================================================================
// HT SigProp/MagRef refinement passes (T.814 §7.3-7.5) — exact mirror of
// entropy/htrefine.py (the Python module is the behavioral reference,
// parity-pinned in tests/test_native.py). Any stream error aborts with a
// nonzero code so the caller re-runs the Python path for exact exception
// semantics.
// ============================================================================

namespace htref {

struct SPRead {  // importSigPropBit (§7.1.5): forward, 7 bits after 0xFF
  const uint8_t* d;
  long n, pos = 0;
  int bits = 0;
  uint32_t tmp = 0, last = 0;
  bool err = false;
  SPRead(const uint8_t* dd, long nn) : d(dd), n(nn) {}
  inline int read() {
    if (bits == 0) {
      bits = (last == 0xFF) ? 7 : 8;
      if (pos < n) {
        tmp = d[pos++];
        if (tmp & (1u << bits)) err = true;  // stuff bit set
      } else {
        tmp = 0;
      }
      last = tmp;
    }
    int b = (int)(tmp & 1);
    tmp >>= 1;
    bits--;
    return b;
  }
};

struct MRRead {  // importMagRefBit (§7.1.6): backward from the segment end
  const uint8_t* d;
  long pos;
  int bits = 0;
  uint32_t tmp = 0, last = 0xFF;
  MRRead(const uint8_t* dd, long nn) : d(dd), pos(nn - 1) {}
  inline int read() {
    if (bits == 0) {
      tmp = pos >= 0 ? d[pos] : 0;
      pos--;
      bits = 8;
      if (last > 0x8F && (tmp & 0x7F) == 0x7F) bits = 7;
      last = tmp;
    }
    int b = (int)(tmp & 1);
    tmp >>= 1;
    bits--;
    return b;
  }
};

struct SPPack {  // emitSPBit / termSPPacker (F.5)
  std::vector<uint8_t> buf;
  int bits = 0, maxb = 8;
  uint32_t tmp = 0;
  inline void emit(int bit) {
    tmp |= (uint32_t)(bit & 1) << bits;
    if (++bits == maxb) {
      buf.push_back((uint8_t)tmp);
      maxb = (tmp == 0xFF) ? 7 : 8;
      tmp = 0;
      bits = 0;
    }
  }
  void terminate(bool followed_by_magref) {
    if (bits && (tmp != 0 || followed_by_magref))
      buf.push_back((uint8_t)tmp);
    if (!buf.empty() && buf.back() == 0xFF) buf.push_back(0x00);
  }
};

struct MRPack {  // emitMRBit (F.5); emitted reversed into the segment
  std::vector<uint8_t> buf;
  int bits = 0;
  uint32_t tmp = 0, last = 255;
  inline void emit(int bit) {
    tmp |= (uint32_t)(bit & 1) << bits;
    bits++;
    if (last > 0x8F && tmp == 0x7F && bits == 7) bits++;  // stuff MSB 0
    if (bits == 8) {
      buf.push_back((uint8_t)tmp);
      last = tmp;
      tmp = 0;
      bits = 0;
    }
  }
  void terminate() {
    if (bits) buf.push_back((uint8_t)tmp);
  }
};

// §7.4 stripe scan over one code-block; OnMag(y, x) -> refinement bit,
// OnSign(y, x) per newly-significant sample, interleaved per
// column-group of four stripe columns. `reach` = σ | r evolving in
// scan order (scan-causal propagation falls out naturally).
template <typename OnMag, typename OnSign>
static void sigprop_scan(const uint8_t* sig, uint8_t* reach, int w, int h,
                         bool causal, OnMag&& on_mag, OnSign&& on_sign) {
  int gy[16], gx[16];
  for (int y0 = 0; y0 < h; y0 += 4) {
    int sh = h - y0 > 4 ? 4 : h - y0;
    for (int x0 = 0; x0 < w; x0 += 4) {
      int gw = w - x0 > 4 ? 4 : w - x0;
      int ngroup = 0;
      for (int dx = 0; dx < gw; dx++) {
        int x = x0 + dx;
        for (int j = 0; j < sh; j++) {
          int y = y0 + j;
          if (sig[(size_t)y * w + x]) continue;
          int ylo = y > 0 ? y - 1 : 0;
          int yhi = (j < sh - 1 || !causal) ? y + 2 : y + 1;
          if (yhi > h) yhi = h;
          int xlo = x > 0 ? x - 1 : 0;
          int xhi = x + 2 < w ? x + 2 : w;
          bool mbr = false;
          for (int yy = ylo; yy < yhi && !mbr; yy++)
            for (int xx = xlo; xx < xhi; xx++)
              if (reach[(size_t)yy * w + xx]) { mbr = true; break; }
          if (!mbr) continue;
          int r = on_mag(y, x);
          if (r) {
            reach[(size_t)y * w + x] = 1;
            gy[ngroup] = y;
            gx[ngroup] = x;
            ngroup++;
          }
        }
      }
      for (int k = 0; k < ngroup; k++) on_sign(gy[k], gx[k]);
    }
  }
}

// One refinement application, generic over the value type: the int64
// form serves the scalar ctypes ABI below; the int32 form runs in
// place on the batched cleanup output (cleanup magnitudes fit int32,
// refinement only sets plane 0 and signs). Single walk = single
// behavior, parity-pinned once.
template <typename VT>
static int refine_apply_impl(const VT* w_in, int w, int h,
                             const uint8_t* dref, long dref_len, int zblk,
                             int causal, VT* out) {
  std::vector<uint8_t> sig((size_t)w * h), reach((size_t)w * h);
  std::vector<uint8_t> neg((size_t)w * h, 0);
  for (long i = 0; i < (long)w * h; i++) {
    VT v = w_in[i];
    sig[i] = v != 0;
    reach[i] = sig[i];
    neg[i] = v < 0;
    out[i] = v < 0 ? -v : v;
  }
  SPRead sp(dref, dref_len);
  sigprop_scan(
      sig.data(), reach.data(), w, h, causal != 0,
      [&](int y, int x) { return sp.read(); },
      [&](int y, int x) {
        if (sp.read()) neg[(size_t)y * w + x] = 1;
        out[(size_t)y * w + x] = 1;
      });
  if (sp.err) return -1;
  if (zblk >= 3) {
    MRRead mr(dref, dref_len);
    for (int y0 = 0; y0 < h; y0 += 4) {
      int sh = h - y0 > 4 ? 4 : h - y0;
      for (int x = 0; x < w; x++)
        for (int j = 0; j < sh; j++) {
          size_t i = (size_t)(y0 + j) * w + x;
          if (sig[i]) out[i] = (out[i] & ~(VT)1) | mr.read();
        }
    }
  }
  for (long i = 0; i < (long)w * h; i++)
    if (neg[i]) out[i] = -out[i];
  return 0;
}

}  // namespace htref

extern "C" {

// Decode: apply an HT refinement segment to cleanup output `w_in`
// (int64, Z>=2 signalling — midpoint half-bit already present).
// Returns 0 ok, -1 stream error (caller re-runs the Python reference).
int ht_refine_apply(const int64_t* w_in, int w, int h,
                    const uint8_t* dref, long dref_len, int zblk,
                    int causal, int64_t* out) {
  return htref::refine_apply_impl<int64_t>(w_in, w, h, dref, dref_len,
                                           zblk, causal, out);
}

// Batched HT cleanup + refinement decode (role: keep multipass HTJ2K
// streams on ONE ctypes round trip + the per-codeblock thread pool,
// like ht_cleanup_decode_blocks does for cleanup-only streams).
// Segment i spans [offs[i], offs[i+1]) and splits at cu_lens[i] into
// cleanup | SigProp(+MagRef) refinement; an empty refinement side
// means Z_blk=1 (cleanup stands alone). zblks[i] = pass count,
// causals[i] = COD cb_style causal bit. status: cleanup codes as in
// ht_cleanup_decode_blocks; 900 = refinement stream error, 901 = bad
// split (caller re-runs the scalar/Python path for exact semantics).
int ht_decode_blocks_refined(const uint8_t* data, const int64_t* offs,
                             const int64_t* cu_lens, const int32_t* ws,
                             const int32_t* hs, const int32_t* kmaxs,
                             const int32_t* missings, const int32_t* zblks,
                             const int32_t* causals, int nb,
                             const int32_t* dec_lut0,
                             const int32_t* dec_lut1, int32_t* out,
                             const int64_t* out_offsets, int32_t* status) {
  parallel_blocks(nb, batch_threads(nb), [&](int i) {
    int32_t* dst = out + out_offsets[i];
    const long seg_len = (long)(offs[i + 1] - offs[i]);
    const long cu = (long)cu_lens[i];
    if (cu < 0 || cu > seg_len) {
      status[i] = 901;
    } else {
      status[i] = ht_cleanup_decode_impl(data + offs[i], cu, ws[i], hs[i],
                                         kmaxs[i], missings[i], dec_lut0,
                                         dec_lut1, dst);
      if (status[i] == 0 && seg_len > cu &&
          htref::refine_apply_impl<int32_t>(dst, ws[i], hs[i],
                                            data + offs[i] + cu,
                                            seg_len - cu, zblks[i],
                                            causals[i], dst) != 0)
        status[i] = 900;
    }
    if (status[i] != 0)
      memset(dst, 0, (size_t)ws[i] * hs[i] * sizeof(int32_t));
  });
  return 0;
}

// Encode: SigProp + MagRef for block values v (int32). Writes the
// refinement segment into `out` (cap `out_cap`); returns its length or
// -1 on overflow. sp_len_out = terminated SigProp byte count (the
// 2-pass truncation point); exact_out = 0 when some plane-0 one is
// not SigProp-reachable; n_new/n_ref feed PCRD distortion deltas.
long ht_refine_encode(const int32_t* v, int w, int h, int causal,
                      uint8_t* out, long out_cap, int* sp_len_out,
                      int* exact_out, int* n_new_out, int* n_ref_out) {
  long n = (long)w * h;
  std::vector<uint8_t> sig((size_t)n), reach((size_t)n), lsb((size_t)n),
      covered((size_t)n, 0);
  bool any_sig = false;
  for (long i = 0; i < n; i++) {
    int64_t av = v[i] < 0 ? -(int64_t)v[i] : v[i];
    sig[i] = (av >> 1) != 0;
    reach[i] = sig[i];
    lsb[i] = (uint8_t)(av & 1);
    any_sig |= sig[i] != 0;
  }
  htref::SPPack sp;
  int n_new = 0;
  htref::sigprop_scan(
      sig.data(), reach.data(), w, h, causal != 0,
      [&](int y, int x) {
        size_t i = (size_t)y * w + x;
        covered[i] = 1;
        int r = lsb[i];
        sp.emit(r);
        return r;
      },
      [&](int y, int x) {
        n_new++;
        sp.emit(v[(size_t)y * w + x] < 0 ? 1 : 0);
      });
  int exact = 1;
  for (long i = 0; i < n; i++)
    if (!covered[i] && !sig[i] && lsb[i]) { exact = 0; break; }
  sp.terminate(any_sig);

  htref::MRPack mr;
  int n_ref = 0;
  for (int y0 = 0; y0 < h; y0 += 4) {
    int sh = h - y0 > 4 ? 4 : h - y0;
    for (int x = 0; x < w; x++)
      for (int j = 0; j < sh; j++) {
        size_t i = (size_t)(y0 + j) * w + x;
        if (sig[i]) {
          mr.emit(lsb[i]);
          if (!lsb[i]) n_ref++;
        }
      }
  }
  mr.terminate();
  long total = (long)(sp.buf.size() + mr.buf.size());
  if (total > out_cap) return -1;
  memcpy(out, sp.buf.data(), sp.buf.size());
  for (size_t k = 0; k < mr.buf.size(); k++)  // reversed MagRef bytes
    out[sp.buf.size() + k] = mr.buf[mr.buf.size() - 1 - k];
  *sp_len_out = (int)sp.buf.size();
  *exact_out = exact;
  *n_new_out = n_new;
  *n_ref_out = n_ref;
  return total;
}

// Batched SigProp/MagRef ENCODE prep (role: one ctypes round trip +
// the per-codeblock thread pool for everything _prep_ht_refinement in
// codecs/jpeg2000.py did per block with numpy temporaries): for each
// block decide 3-pass eligibility, emit the refinement segment into
// dref_out[dref_offs[i]..], write the cleanup source u = sign·(|v|>>1)
// into u_out at the block's own offset, and compute the T.800 J.4
// distortion deltas (×128 at plane 0: cleanup leaves (1-lsb) on
// samples with |v|>1 and lsb elsewhere; SigProp removes 1 per newly-
// significant; MagRef 1 per lsb=0 refinement — int64 wrap semantics
// match numpy). status: 0 = refined, 1 = keep the single full-
// precision cleanup pass (all-|v|<=1 or not exactly SigProp-reachable),
// 2 = segment overflow (caller re-runs the scalar/Python prep).
int ht_refine_encode_blocks(const int32_t* v, const int64_t* v_offs,
                            const int32_t* ws, const int32_t* hs,
                            int causal, int nb, int32_t* u_out,
                            uint8_t* dref_out, const int64_t* dref_offs,
                            int64_t* dref_lens, int32_t* sp_lens,
                            int64_t* nms_out, int32_t* status) {
  parallel_blocks(nb, batch_threads(nb), [&](int i) {
    const int32_t* src = v + v_offs[i];
    const long n = (long)ws[i] * hs[i];
    bool any = false;
    for (long k = 0; k < n && !any; k++) {
      int64_t av = src[k] < 0 ? -(int64_t)src[k] : src[k];
      any = av > 1;
    }
    if (!any) { status[i] = 1; return; }
    uint8_t* dst = dref_out + dref_offs[i];
    const long cap = (long)(dref_offs[i + 1] - dref_offs[i]);
    int sp = 0, exact = 0, nnew = 0, nref = 0;
    long len = ht_refine_encode(src, ws[i], hs[i], causal, dst, cap,
                                &sp, &exact, &nnew, &nref);
    if (len < 0) { status[i] = 2; return; }
    if (!exact) { status[i] = 1; return; }
    int64_t energy = 0, after_cp = 0;
    int32_t* u = u_out + v_offs[i];
    for (long k = 0; k < n; k++) {
      const int64_t vv = src[k];
      const int64_t av = vv < 0 ? -vv : vv;
      energy += av * av;
      const int64_t lsb = av & 1;
      after_cp += av > 1 ? (lsb ^ 1) : lsb;
      const int64_t uu = av >> 1;
      u[k] = (int32_t)(vv < 0 ? -uu : uu);
    }
    dref_lens[i] = len;
    sp_lens[i] = sp;
    nms_out[(size_t)i * 3] = 128 * (energy - after_cp);
    nms_out[(size_t)i * 3 + 1] = 128 * (int64_t)nnew;
    nms_out[(size_t)i * 3 + 2] = 128 * (int64_t)nref;
    status[i] = 0;
  });
  return 0;
}

}  // extern "C"

// ============================================================================
// Reversible 5/3 lifting DWT host fast path — exact mirror of ops/dwt53.py
// (the JAX module is the behavioral reference, pinned by equivalence tests
// in tests/test_native.py; reference semantics jpeg2000/wavelet/dwt53.go).
// int32 arithmetic with arithmetic right shifts, packed Mallat layout,
// parity-aware per-level windows. The vertical pass is expressed row-wise
// (whole-row vector ops) for cache friendliness and autovectorization.
// ============================================================================

namespace {

// forward 1D over a contiguous line [n] -> packed [L | H] (ops/dwt53.py
// fwd53_1d). tmp must hold n values.
void f53_line(int32_t* x, int n, bool even, int32_t* tmp) {
  if (n <= 1) {
    if (!even && n == 1) x[0] *= 2;
    return;
  }
  if (even) {
    int sn = (n + 1) / 2, dn = n / 2;
    int32_t* l = tmp;
    int32_t* h = tmp + sn;
    for (int i = 0; i < dn; i++) {
      int32_t s_i = x[2 * i], s_n = x[2 * (i + 1 < sn ? i + 1 : sn - 1)];
      h[i] = x[2 * i + 1] - ((s_i + s_n) >> 1);
    }
    for (int i = 0; i < sn; i++) {
      int32_t hp = h[i - 1 < 0 ? 0 : (i - 1 < dn ? i - 1 : dn - 1)];
      int32_t hc = h[i < dn ? i : dn - 1];
      l[i] = x[2 * i] + ((hp + hc + 2) >> 2);
    }
  } else {
    int sn = n / 2, dn = n - sn;
    int32_t* l = tmp;
    int32_t* h = tmp + sn;
    for (int i = 0; i < dn; i++) {
      int32_t sm = x[2 * (i - 1 < 0 ? 0 : i - 1) + 1];
      int32_t si = x[2 * (i < sn ? i : sn - 1) + 1];
      h[i] = x[2 * i] - ((sm + si) >> 1);
    }
    for (int i = 0; i < sn; i++) {
      int32_t hi = h[i];
      int32_t hn = h[i + 1 < dn ? i + 1 : dn - 1];
      l[i] = x[2 * i + 1] + ((hi + hn + 2) >> 2);
    }
  }
  memcpy(x, tmp, sizeof(int32_t) * (size_t)n);
}

// inverse 1D from packed [L | H] (ops/dwt53.py inv53_1d)
void i53_line(int32_t* x, int n, bool even, int32_t* tmp) {
  if (n <= 1) {
    if (!even && n == 1) x[0] >>= 1;
    return;
  }
  if (even) {
    int sn = (n + 1) / 2, dn = n - sn;
    const int32_t* l = x;
    const int32_t* h = x + sn;
    int32_t* s = tmp;  // [sn]
    for (int i = 0; i < sn; i++) {
      int32_t hp = h[i - 1 < 0 ? 0 : (i - 1 < dn ? i - 1 : dn - 1)];
      int32_t hc = h[i < dn ? i : dn - 1];
      s[i] = l[i] - ((hp + hc + 2) >> 2);
    }
    int32_t* od = tmp + sn;  // odd samples [dn]
    for (int i = 0; i < dn; i++)
      od[i] = h[i] + ((s[i] + s[i + 1 < sn ? i + 1 : sn - 1]) >> 1);
    for (int i = 0; i < sn; i++) x[2 * i] = s[i];
    for (int i = 0; i < dn; i++) x[2 * i + 1] = od[i];
  } else {
    int sn = n / 2, dn = n - sn;
    const int32_t* l = x;
    const int32_t* h = x + sn;
    int32_t* s = tmp;  // [sn]
    for (int i = 0; i < sn; i++) {
      int32_t hi = h[i < dn ? i : dn - 1];
      int32_t hn = h[i + 1 < dn ? i + 1 : dn - 1];
      s[i] = l[i] - ((hi + hn + 2) >> 2);
    }
    int32_t* ev = tmp + sn;  // even samples [dn]
    for (int i = 0; i < dn; i++) {
      int32_t sm = s[i - 1 < 0 ? 0 : (i - 1 < sn ? i - 1 : sn - 1)];
      int32_t si = s[i < sn ? i : sn - 1];
      ev[i] = h[i] + ((sm + si) >> 1);
    }
    for (int i = 0; i < dn; i++) x[2 * i] = ev[i];
    for (int i = 0; i < sn; i++) x[2 * i + 1] = s[i];
  }
}

// vertical forward pass over window [h x w] with row stride, row-wise
// vector ops into a packed temp then copied back
void f53_vert(int32_t* a, int h, int w, long stride, bool even,
              std::vector<int32_t>& scratch) {
  if (h <= 1) {
    if (!even && h == 1)
      for (int x = 0; x < w; x++) a[x] *= 2;
    return;
  }
  scratch.resize((size_t)h * w);
  int32_t* t = scratch.data();
  auto row = [&](int y) { return a + (size_t)y * stride; };
  if (even) {
    int sn = (h + 1) / 2, dn = h / 2;
    // H rows: t[sn+i] = row(2i+1) - ((row(2i) + row(2(i+1 cl))) >> 1)
    for (int i = 0; i < dn; i++) {
      const int32_t* s0 = row(2 * i);
      const int32_t* s1 = row(2 * (i + 1 < sn ? i + 1 : sn - 1));
      const int32_t* d = row(2 * i + 1);
      int32_t* o = t + (size_t)(sn + i) * w;
      for (int x = 0; x < w; x++) o[x] = d[x] - ((s0[x] + s1[x]) >> 1);
    }
    // L rows: t[i] = row(2i) + ((hp + hc + 2) >> 2)
    for (int i = 0; i < sn; i++) {
      const int32_t* hp =
          t + (size_t)(sn + (i - 1 < 0 ? 0 : (i - 1 < dn ? i - 1 : dn - 1))) * w;
      const int32_t* hc = t + (size_t)(sn + (i < dn ? i : dn - 1)) * w;
      const int32_t* s = row(2 * i);
      int32_t* o = t + (size_t)i * w;
      for (int x = 0; x < w; x++) o[x] = s[x] + ((hp[x] + hc[x] + 2) >> 2);
    }
  } else {
    int sn = h / 2, dn = h - sn;
    for (int i = 0; i < dn; i++) {
      const int32_t* sm = row(2 * (i - 1 < 0 ? 0 : i - 1) + 1);
      const int32_t* si = row(2 * (i < sn ? i : sn - 1) + 1);
      const int32_t* d = row(2 * i);
      int32_t* o = t + (size_t)(sn + i) * w;
      for (int x = 0; x < w; x++) o[x] = d[x] - ((sm[x] + si[x]) >> 1);
    }
    for (int i = 0; i < sn; i++) {
      const int32_t* hi = t + (size_t)(sn + i) * w;
      const int32_t* hn = t + (size_t)(sn + (i + 1 < dn ? i + 1 : dn - 1)) * w;
      const int32_t* s = row(2 * i + 1);
      int32_t* o = t + (size_t)i * w;
      for (int x = 0; x < w; x++) o[x] = s[x] + ((hi[x] + hn[x] + 2) >> 2);
    }
  }
  for (int y = 0; y < h; y++)
    memcpy(row(y), t + (size_t)y * w, sizeof(int32_t) * (size_t)w);
}

// vertical inverse pass
void i53_vert(int32_t* a, int h, int w, long stride, bool even,
              std::vector<int32_t>& scratch) {
  if (h <= 1) {
    if (!even && h == 1)
      for (int x = 0; x < w; x++) a[x] >>= 1;
    return;
  }
  scratch.resize((size_t)h * w);
  int32_t* t = scratch.data();
  auto row = [&](int y) { return a + (size_t)y * stride; };
  if (even) {
    int sn = (h + 1) / 2, dn = h - sn;
    // s rows (even outputs): t[2i] from L minus update
    for (int i = 0; i < sn; i++) {
      const int32_t* hp =
          row(sn + (i - 1 < 0 ? 0 : (i - 1 < dn ? i - 1 : dn - 1)));
      const int32_t* hc = row(sn + (i < dn ? i : dn - 1));
      const int32_t* l = row(i);
      int32_t* o = t + (size_t)(2 * i) * w;
      for (int x = 0; x < w; x++) o[x] = l[x] - ((hp[x] + hc[x] + 2) >> 2);
    }
    for (int i = 0; i < dn; i++) {
      const int32_t* s0 = t + (size_t)(2 * i) * w;
      const int32_t* s1 = t + (size_t)(2 * (i + 1 < sn ? i + 1 : sn - 1)) * w;
      const int32_t* hh = row(sn + i);
      int32_t* o = t + (size_t)(2 * i + 1) * w;
      for (int x = 0; x < w; x++) o[x] = hh[x] + ((s0[x] + s1[x]) >> 1);
    }
  } else {
    int sn = h / 2, dn = h - sn;
    for (int i = 0; i < sn; i++) {
      const int32_t* hi = row(sn + (i < dn ? i : dn - 1));
      const int32_t* hn = row(sn + (i + 1 < dn ? i + 1 : dn - 1));
      const int32_t* l = row(i);
      int32_t* o = t + (size_t)(2 * i + 1) * w;
      for (int x = 0; x < w; x++) o[x] = l[x] - ((hi[x] + hn[x] + 2) >> 2);
    }
    for (int i = 0; i < dn; i++) {
      const int32_t* sm =
          t + (size_t)(2 * (i - 1 < 0 ? 0 : (i - 1 < sn ? i - 1 : sn - 1)) + 1) * w;
      const int32_t* si = t + (size_t)(2 * (i < sn ? i : sn - 1) + 1) * w;
      const int32_t* hh = row(sn + i);
      int32_t* o = t + (size_t)(2 * i) * w;
      for (int x = 0; x < w; x++) o[x] = hh[x] + ((sm[x] + si[x]) >> 1);
    }
  }
  for (int y = 0; y < h; y++)
    memcpy(row(y), t + (size_t)y * w, sizeof(int32_t) * (size_t)w);
}

void dwt_windows(int width, int height, int levels, int x0, int y0,
                 std::vector<std::array<int, 4>>& wins) {
  int w = width, h = height;
  for (int i = 0; i < levels; i++) {
    if (w == 0 || h == 0) break;
    wins.push_back({w, h, x0, y0});
    int nw = (x0 % 2 == 0) ? (w + 1) / 2 : w / 2;
    int nh = (y0 % 2 == 0) ? (h + 1) / 2 : h / 2;
    x0 = (x0 + 1) >> 1; y0 = (y0 + 1) >> 1;
    w = nw; h = nh;
  }
}

}  // namespace

extern "C" {

// In-place multilevel forward 5/3 on int32 [height x width] (row-major,
// stride == width). Mirrors ops/dwt53.py fwd53_multilevel.
int dwt53_fwd(int32_t* data, int width, int height, int levels, int x0,
              int y0) {
  if (width <= 0 || height <= 0) return 0;
  std::vector<std::array<int, 4>> wins;
  dwt_windows(width, height, levels, x0, y0, wins);
  std::vector<int32_t> scratch, line;
  for (auto& win : wins) {
    int w = win[0], h = win[1];
    bool even_row = win[2] % 2 == 0, even_col = win[3] % 2 == 0;
    // vertical first (fwd53_2d), then horizontal
    if (h > 1 || (h == 1 && !even_col))
      f53_vert(data, h, w, width, even_col, scratch);
    if (w > 1 || (w == 1 && !even_row)) {
      line.resize((size_t)w);
      for (int y = 0; y < h; y++)
        f53_line(data + (size_t)y * width, w, even_row, line.data());
    }
  }
  return 0;
}

// In-place multilevel inverse 5/3. Mirrors ops/dwt53.py inv53_multilevel.
int dwt53_inv(int32_t* data, int width, int height, int levels, int x0,
              int y0) {
  if (width <= 0 || height <= 0) return 0;
  std::vector<std::array<int, 4>> wins;
  dwt_windows(width, height, levels, x0, y0, wins);
  std::vector<int32_t> scratch, line;
  for (auto it = wins.rbegin(); it != wins.rend(); ++it) {
    int w = (*it)[0], h = (*it)[1];
    bool even_row = (*it)[2] % 2 == 0, even_col = (*it)[3] % 2 == 0;
    // horizontal first (inv53_2d), then vertical
    if (w > 1 || (w == 1 && !even_row)) {
      line.resize((size_t)w);
      for (int y = 0; y < h; y++)
        i53_line(data + (size_t)y * width, w, even_row, line.data());
    }
    if (h > 1 || (h == 1 && !even_col))
      i53_vert(data, h, w, width, even_col, scratch);
  }
  return 0;
}

}  // extern "C"

// ============================================================================
// JPEG lossless (P14/SV1) fused fast paths — exact mirrors of
// ops/lossless_predict.encode_diffs + entropy/huffman categories
// (behavioral reference; parity pinned in tests/test_native.py).
// ============================================================================

extern "C" {

// Fused predict + diff + category histogram for one [h x w] plane.
// samples: int32 (original pixel values); predictor 1..7; diffs_out:
// int32 [h*w] int16-wrapped differences; hist17: int64 [17] category
// counts (accumulated, not cleared). Mirrors encode_diffs +
// p14_cat_hist semantics.
}  // extern "C"

// Interior diff row (y >= 1, x >= 1): predictor templated so the inner
// loop is branch-free and auto-vectorizes (P14 predicts from ORIGINAL
// neighbors — no output recurrence, so the row is elementwise).
template <int P>
static inline void p14_diff_row(const int32_t* row, const int32_t* up,
                                int32_t* drow, int w) {
  for (int x = 1; x < w; x++) {
    int32_t ra = row[x - 1], rb = up[x], rc = up[x - 1];
    int32_t pred = P == 1   ? ra
                   : P == 2 ? rb
                   : P == 3 ? rc
                   : P == 4 ? ra + rb - rc
                   : P == 5 ? ra + ((rb - rc) >> 1)
                   : P == 6 ? rb + ((ra - rc) >> 1)
                            : (ra + rb) >> 1;
    drow[x] = (((row[x] - pred) + 0x8000) & 0xFFFF) - 0x8000;
  }
}

extern "C" {

int p14_diffs_hist(const int32_t* samples, int w, int h, int predictor,
                   int precision, int32_t* diffs_out, int64_t* hist17) {
  if (w <= 0 || h <= 0 || predictor < 1 || predictor > 7) return -1;
  const int32_t dflt = 1 << (precision - 1);
  for (int y = 0; y < h; y++) {
    const int32_t* row = samples + (size_t)y * w;
    const int32_t* up = y > 0 ? row - w : nullptr;
    int32_t* drow = diffs_out + (size_t)y * w;
    if (y == 0) {
      // T.81 H.1.2.2 first line: Px = Ra for every predictor (mirrors
      // ops/lossless_predict.encode_diffs)
      drow[0] = (((row[0] - dflt) + 0x8000) & 0xFFFF) - 0x8000;
      for (int x = 1; x < w; x++)
        drow[x] = (((row[x] - row[x - 1]) + 0x8000) & 0xFFFF) - 0x8000;
    } else {
      // T.81 H.1.2.2 first column: Px = Rb for every predictor
      drow[0] = (((row[0] - up[0]) + 0x8000) & 0xFFFF) - 0x8000;
      switch (predictor) {
        case 1: p14_diff_row<1>(row, up, drow, w); break;
        case 2: p14_diff_row<2>(row, up, drow, w); break;
        case 3: p14_diff_row<3>(row, up, drow, w); break;
        case 4: p14_diff_row<4>(row, up, drow, w); break;
        case 5: p14_diff_row<5>(row, up, drow, w); break;
        case 6: p14_diff_row<6>(row, up, drow, w); break;
        default: p14_diff_row<7>(row, up, drow, w); break;
      }
    }
    // histogram pass (scalar scatter, separate so the diff loop above
    // stays vectorized)
    for (int x = 0; x < w; x++) {
      int32_t d = drow[x];
      int cat;
      if (d == -32768) cat = 16;
      else {
        uint32_t a = (uint32_t)(d < 0 ? -d : d);
        cat = a ? 32 - __builtin_clz(a) : 0;
      }
      hist17[cat]++;
    }
  }
  return 0;
}

// int32 variant of p14_pack_scan: fused (code|ebits) single put into a
// raw (unstuffed) buffer, then one memchr-driven FF->FF00 stuffing pass
// — removes the per-byte bounds/stuff branches from the hot loop.
long p14_pack_scan32(const int32_t* diffs, long n, const int32_t* codes,
                     const int32_t* lens, uint8_t* out, long out_cap) {
  std::vector<uint8_t> raw((size_t)n * 4 + 16);
  uint8_t* rp = raw.data();
  size_t ro = 0;
  // branchless MSB-first writer (same as jpg_encode_scan2): acc holds
  // pending bits left-aligned, every put stores the whole 8-byte window
  // and advances by completed bytes (len <= 32+16, nacc stays < 8)
  uint64_t acc = 0;
  int nacc = 0;
  auto put = [&](uint64_t v, int len) {
    if (!len) return;  // degenerate table; also avoids 64-bit-shift UB
    acc |= (v & (~0ull >> (64 - len))) << (64 - nacc - len);
    nacc += len;
    uint64_t wv = __builtin_bswap64(acc);
    memcpy(rp + ro, &wv, 8);
    int nb = nacc >> 3;
    ro += nb;
    acc <<= nb * 8;
    nacc &= 7;
  };
  // chunked: a vectorizable pass precomputes category (float-exponent
  // trick: |d| < 2^24 so (float)|d| is exact and cat = exp - 126) and
  // extend bits; the serial bit-writer loop then only does table
  // lookups and puts.
  const long CH = 2048;
  int32_t catb[CH];
  uint32_t ebb[CH];
  for (long base = 0; base < n; base += CH) {
    long m = n - base < CH ? n - base : CH;
    const int32_t* dp = diffs + base;
    for (long i = 0; i < m; i++) {  // auto-vectorized
      int32_t d = dp[i];
      uint32_t a = (uint32_t)(d < 0 ? -d : d);
      float fa = (float)a;
      int32_t fb;
      memcpy(&fb, &fa, 4);
      int32_t cat = a ? (fb >> 23) - 126 : 0;
      uint32_t msk = (1u << cat) - 1;
      // d>=0: d; d<0: d + 2^cat - 1 (two's-complement masked)
      uint32_t eb = (uint32_t)(d + ((d >> 31) & (int32_t)msk)) & msk;
      catb[i] = cat;
      ebb[i] = eb;
    }
    for (long i = 0; i < m; i++) {
      int cat = catb[i];
      int elen = cat == 16 ? 0 : cat;  // SSSS=16: no extend bits (d=-32768)
      uint32_t eb = cat == 16 ? 0 : ebb[i];
      put(((uint64_t)(uint32_t)codes[cat] << elen) | eb,
          lens[cat] + elen);
    }
  }
  if (nacc > 0) {  // pad to byte with 1-bits (BitW.pad(1) semantics)
    int fill = 8 - nacc;
    put((1u << fill) - 1, fill);
  }
  // FF -> FF 00 stuffing
  long o = 0;
  size_t i = 0;
  while (i < ro) {
    const uint8_t* ff = (const uint8_t*)memchr(rp + i, 0xFF, ro - i);
    size_t run = ff ? (size_t)(ff - (rp + i)) : ro - i;
    if (o + (long)run + 2 > out_cap) return -1;
    memcpy(out + o, rp + i, run);
    o += run;
    i += run;
    if (ff) {
      out[o++] = 0xFF;
      out[o++] = 0x00;
      i++;
    }
  }
  return o;
}

}  // extern "C"

extern "C" {

// Inverse of p14_diffs_hist: diffs -> samples in [0, 2^P). Exact mirror
// of ops/lossless_predict.reconstruct (per-sample recurrence form; the
// numpy module stays the behavioral reference, parity in
// tests/test_native.py).
int p14_reconstruct(const int32_t* diffs, int w, int h, int predictor,
                    int precision, int32_t* out) {
  if (w <= 0 || h <= 0 || predictor < 1 || predictor > 7) return -1;
  const int32_t dflt = 1 << (precision - 1);
  const uint32_t mask = (uint32_t)((1u << precision) - 1);
  for (int y = 0; y < h; y++) {
    const int32_t* drow = diffs + (size_t)y * w;
    int32_t* srow = out + (size_t)y * w;
    const int32_t* up = y > 0 ? srow - w : nullptr;
    for (int x = 0; x < w; x++) {
      int32_t ra = x > 0 ? srow[x - 1] : 0;
      int32_t rb = up ? up[x] : dflt;
      int32_t rc = (up && x > 0) ? up[x - 1] : dflt;
      int32_t pred;
      // T.81 H.1.2.2 boundaries (mirrors ops/lossless_predict.
      // reconstruct): first sample 2^(P-1); rest of first line Ra;
      // first column Rb; interior = the selected formula
      if (x == 0) {
        pred = up ? up[0] : dflt;
      } else if (!up) {
        pred = ra;
      } else {
        switch (predictor) {
          case 1: pred = ra; break;
          case 2: pred = rb; break;
          case 3: pred = rc; break;
          case 4: pred = ra + rb - rc; break;
          case 5: pred = ra + ((rb - rc) >> 1); break;
          case 6: pred = rb + ((ra - rc) >> 1); break;
          default: pred = (ra + rb) >> 1; break;
        }
      }
      srow[x] = (int32_t)((uint32_t)(pred + drow[x]) & mask);
    }
  }
  return 0;
}

}  // extern "C"

// ---- JPEG 8x8 DCT host fast path -------------------------------------------
// Host mirror of ops/dct_int.py (role of reference jpeg/standard/dct_ijg.go,
// idct_ijg.go and the 12-bit variant sequential12.go:239): the integer IJG
// islow DCT, CONST_BITS=13 / PASS1_BITS=2, forward output retains the
// factor-of-8 scale removed by a round-half-away /8q quantizer.  Pure int32
// arithmetic (built with -fwrapv) so the result is byte-identical to the
// numpy and jit lanes on any backend — lossy JPEG streams are deterministic
// across lanes by construction.  Butterfly passes are written lane-wise
// (inner loop over 8 int32 lanes, `final` hoisted to a template parameter)
// so -O3 -march=native auto-vectorizes them to AVX2 epi32; quantization is
// a branchless exact floor-division (double reciprocal + one-step fixup).

namespace jdct {

const int ZZ[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int32_t CONST_BITS = 13, PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

static inline int32_t descale(int32_t x, int n) {
  return (x + ((int32_t)1 << (n - 1))) >> n;
}

// One forward islow pass along the FIRST index of in[8][8], lanes over the
// second.  FINAL=false: row pass (even << P1, odd descale CONST-P1);
// FINAL=true: column pass (even descale P1, odd descale CONST+P1).
// P1 is the precision profile: 2 for 8-bit (classic libjpeg), 1 for
// 12-bit (libjpeg-turbo 12-bit / reference sequential12.go:242 — the
// extra headroom bit max-amplitude Nyquist blocks need).
template <bool FINAL, int P1>
static inline void fdct_pass(const int32_t in[8][8], int32_t out[8][8]) {
  const int odd_shift = FINAL ? CONST_BITS + P1 : CONST_BITS - P1;
  for (int j = 0; j < 8; j++) {
    int32_t tmp0 = in[0][j] + in[7][j], tmp7 = in[0][j] - in[7][j];
    int32_t tmp1 = in[1][j] + in[6][j], tmp6 = in[1][j] - in[6][j];
    int32_t tmp2 = in[2][j] + in[5][j], tmp5 = in[2][j] - in[5][j];
    int32_t tmp3 = in[3][j] + in[4][j], tmp4 = in[3][j] - in[4][j];

    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    if (FINAL) {
      out[0][j] = descale(tmp10 + tmp11, P1);
      out[4][j] = descale(tmp10 - tmp11, P1);
    } else {
      out[0][j] = (tmp10 + tmp11) * (1 << P1);
      out[4][j] = (tmp10 - tmp11) * (1 << P1);
    }

    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    out[2][j] = descale(z1 + tmp13 * FIX_0_765366865, odd_shift);
    out[6][j] = descale(z1 - tmp12 * FIX_1_847759065, odd_shift);

    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;

    out[7][j] = descale(tmp4 + z1 + z3, odd_shift);
    out[5][j] = descale(tmp5 + z2 + z4, odd_shift);
    out[3][j] = descale(tmp6 + z2 + z3, odd_shift);
    out[1][j] = descale(tmp7 + z1 + z4, odd_shift);
  }
}

// One inverse islow pass along the FIRST index, lanes over the second.
// FINAL=false: descale CONST-P1; FINAL=true: output stage, descale
// CONST+P1+3 (level shift/clamp are the caller's).  The 12-bit profile
// calls the final pass with P1=0: its dequantized coefficients were
// pre-halved for int32 headroom, and 13+0+3 == the compensated shift.
template <bool FINAL, int P1>
static inline void idct_pass(const int32_t in[8][8], int32_t out[8][8]) {
  const int shift = FINAL ? (CONST_BITS + P1 + 3) : (CONST_BITS - P1);
  for (int j = 0; j < 8; j++) {
    int32_t z2 = in[2][j], z3 = in[6][j];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 - z3 * FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t t0 = (in[0][j] + in[4][j]) * (1 << CONST_BITS);
    int32_t t1 = (in[0][j] - in[4][j]) * (1 << CONST_BITS);
    int32_t tmp10 = t0 + tmp3, tmp13 = t0 - tmp3;
    int32_t tmp11 = t1 + tmp2, tmp12 = t1 - tmp2;

    int32_t tmp0 = in[7][j], tmp1 = in[5][j];
    tmp2 = in[3][j];
    tmp3 = in[1][j];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    out[0][j] = descale(tmp10 + tmp3, shift);
    out[7][j] = descale(tmp10 - tmp3, shift);
    out[1][j] = descale(tmp11 + tmp2, shift);
    out[6][j] = descale(tmp11 - tmp2, shift);
    out[2][j] = descale(tmp12 + tmp1, shift);
    out[5][j] = descale(tmp12 - tmp1, shift);
    out[3][j] = descale(tmp13 + tmp0, shift);
    out[4][j] = descale(tmp13 - tmp0, shift);
  }
}

#if defined(__AVX2__)
// Register-resident AVX2 mirrors of the passes above: one __m256i per
// butterfly element, lanes over the other axis.  Same int32 sequence —
// vpmulld/vpaddd/vpsrad are exact, so parity with the scalar/np/jnp
// lanes is preserved.
namespace avx {
typedef __m256i V;
static inline V vadd(V a, V b) { return _mm256_add_epi32(a, b); }
static inline V vsub(V a, V b) { return _mm256_sub_epi32(a, b); }
static inline V vmul(V a, int32_t c) {
  return _mm256_mullo_epi32(a, _mm256_set1_epi32(c));
}
static inline V vdesc(V x, int n) {
  return _mm256_srai_epi32(
      _mm256_add_epi32(x, _mm256_set1_epi32(1 << (n - 1))), n);
}

static inline void transpose(V r[8]) {
  V t0 = _mm256_unpacklo_epi32(r[0], r[1]);
  V t1 = _mm256_unpackhi_epi32(r[0], r[1]);
  V t2 = _mm256_unpacklo_epi32(r[2], r[3]);
  V t3 = _mm256_unpackhi_epi32(r[2], r[3]);
  V t4 = _mm256_unpacklo_epi32(r[4], r[5]);
  V t5 = _mm256_unpackhi_epi32(r[4], r[5]);
  V t6 = _mm256_unpacklo_epi32(r[6], r[7]);
  V t7 = _mm256_unpackhi_epi32(r[6], r[7]);
  V u0 = _mm256_unpacklo_epi64(t0, t2);
  V u1 = _mm256_unpackhi_epi64(t0, t2);
  V u2 = _mm256_unpacklo_epi64(t1, t3);
  V u3 = _mm256_unpackhi_epi64(t1, t3);
  V u4 = _mm256_unpacklo_epi64(t4, t6);
  V u5 = _mm256_unpackhi_epi64(t4, t6);
  V u6 = _mm256_unpacklo_epi64(t5, t7);
  V u7 = _mm256_unpackhi_epi64(t5, t7);
  r[0] = _mm256_permute2x128_si256(u0, u4, 0x20);
  r[1] = _mm256_permute2x128_si256(u1, u5, 0x20);
  r[2] = _mm256_permute2x128_si256(u2, u6, 0x20);
  r[3] = _mm256_permute2x128_si256(u3, u7, 0x20);
  r[4] = _mm256_permute2x128_si256(u0, u4, 0x31);
  r[5] = _mm256_permute2x128_si256(u1, u5, 0x31);
  r[6] = _mm256_permute2x128_si256(u2, u6, 0x31);
  r[7] = _mm256_permute2x128_si256(u3, u7, 0x31);
}

template <bool FINAL, int P1>
static inline void fdct_pass(const V d[8], V o[8]) {
  const int odd = FINAL ? CONST_BITS + P1 : CONST_BITS - P1;
  V tmp0 = vadd(d[0], d[7]), tmp7 = vsub(d[0], d[7]);
  V tmp1 = vadd(d[1], d[6]), tmp6 = vsub(d[1], d[6]);
  V tmp2 = vadd(d[2], d[5]), tmp5 = vsub(d[2], d[5]);
  V tmp3 = vadd(d[3], d[4]), tmp4 = vsub(d[3], d[4]);
  V t10 = vadd(tmp0, tmp3), t13 = vsub(tmp0, tmp3);
  V t11 = vadd(tmp1, tmp2), t12 = vsub(tmp1, tmp2);
  if (FINAL) {
    o[0] = vdesc(vadd(t10, t11), P1);
    o[4] = vdesc(vsub(t10, t11), P1);
  } else {
    o[0] = _mm256_slli_epi32(vadd(t10, t11), P1);
    o[4] = _mm256_slli_epi32(vsub(t10, t11), P1);
  }
  V z1 = vmul(vadd(t12, t13), FIX_0_541196100);
  o[2] = vdesc(vadd(z1, vmul(t13, FIX_0_765366865)), odd);
  o[6] = vdesc(vsub(z1, vmul(t12, FIX_1_847759065)), odd);
  V za = vadd(tmp4, tmp7), zb = vadd(tmp5, tmp6);
  V zc = vadd(tmp4, tmp6), zd = vadd(tmp5, tmp7);
  V z5 = vmul(vadd(zc, zd), FIX_1_175875602);
  V m4 = vmul(tmp4, FIX_0_298631336), m5 = vmul(tmp5, FIX_2_053119869);
  V m6 = vmul(tmp6, FIX_3_072711026), m7 = vmul(tmp7, FIX_1_501321110);
  V n1 = vmul(za, -FIX_0_899976223), n2 = vmul(zb, -FIX_2_562915447);
  V n3 = vadd(vmul(zc, -FIX_1_961570560), z5);
  V n4 = vadd(vmul(zd, -FIX_0_390180644), z5);
  o[7] = vdesc(vadd(vadd(m4, n1), n3), odd);
  o[5] = vdesc(vadd(vadd(m5, n2), n4), odd);
  o[3] = vdesc(vadd(vadd(m6, n2), n3), odd);
  o[1] = vdesc(vadd(vadd(m7, n1), n4), odd);
}

template <bool FINAL, int P1>
static inline void idct_pass(const V d[8], V o[8]) {
  const int shift = FINAL ? (CONST_BITS + P1 + 3) : (CONST_BITS - P1);
  V z2 = d[2], z3 = d[6];
  V z1 = vmul(vadd(z2, z3), FIX_0_541196100);
  V tmp2 = vsub(z1, vmul(z3, FIX_1_847759065));
  V tmp3 = vadd(z1, vmul(z2, FIX_0_765366865));
  V t0 = _mm256_slli_epi32(vadd(d[0], d[4]), CONST_BITS);
  V t1 = _mm256_slli_epi32(vsub(d[0], d[4]), CONST_BITS);
  V t10 = vadd(t0, tmp3), t13 = vsub(t0, tmp3);
  V t11 = vadd(t1, tmp2), t12 = vsub(t1, tmp2);

  V a0 = d[7], a1 = d[5], a2 = d[3], a3 = d[1];
  V w1 = vadd(a0, a3), w2 = vadd(a1, a2);
  V w3 = vadd(a0, a2), w4 = vadd(a1, a3);
  V z5 = vmul(vadd(w3, w4), FIX_1_175875602);
  a0 = vmul(a0, FIX_0_298631336);
  a1 = vmul(a1, FIX_2_053119869);
  a2 = vmul(a2, FIX_3_072711026);
  a3 = vmul(a3, FIX_1_501321110);
  w1 = vmul(w1, -FIX_0_899976223);
  w2 = vmul(w2, -FIX_2_562915447);
  w3 = vadd(vmul(w3, -FIX_1_961570560), z5);
  w4 = vadd(vmul(w4, -FIX_0_390180644), z5);
  a0 = vadd(vadd(a0, w1), w3);
  a1 = vadd(vadd(a1, w2), w4);
  a2 = vadd(vadd(a2, w2), w3);
  a3 = vadd(vadd(a3, w1), w4);

  o[0] = vdesc(vadd(t10, a3), shift);
  o[7] = vdesc(vsub(t10, a3), shift);
  o[1] = vdesc(vadd(t11, a2), shift);
  o[6] = vdesc(vsub(t11, a2), shift);
  o[2] = vdesc(vadd(t12, a1), shift);
  o[5] = vdesc(vsub(t12, a1), shift);
  o[3] = vdesc(vadd(t13, a0), shift);
  o[4] = vdesc(vsub(t13, a0), shift);
}
}  // namespace avx
#endif  // __AVX2__

static inline void transpose8(const int32_t a[8][8], int32_t b[8][8]) {
#if defined(__AVX2__)
  __m256i r0 = _mm256_loadu_si256((const __m256i*)a[0]);
  __m256i r1 = _mm256_loadu_si256((const __m256i*)a[1]);
  __m256i r2 = _mm256_loadu_si256((const __m256i*)a[2]);
  __m256i r3 = _mm256_loadu_si256((const __m256i*)a[3]);
  __m256i r4 = _mm256_loadu_si256((const __m256i*)a[4]);
  __m256i r5 = _mm256_loadu_si256((const __m256i*)a[5]);
  __m256i r6 = _mm256_loadu_si256((const __m256i*)a[6]);
  __m256i r7 = _mm256_loadu_si256((const __m256i*)a[7]);
  __m256i t0 = _mm256_unpacklo_epi32(r0, r1);
  __m256i t1 = _mm256_unpackhi_epi32(r0, r1);
  __m256i t2 = _mm256_unpacklo_epi32(r2, r3);
  __m256i t3 = _mm256_unpackhi_epi32(r2, r3);
  __m256i t4 = _mm256_unpacklo_epi32(r4, r5);
  __m256i t5 = _mm256_unpackhi_epi32(r4, r5);
  __m256i t6 = _mm256_unpacklo_epi32(r6, r7);
  __m256i t7 = _mm256_unpackhi_epi32(r6, r7);
  __m256i u0 = _mm256_unpacklo_epi64(t0, t2);
  __m256i u1 = _mm256_unpackhi_epi64(t0, t2);
  __m256i u2 = _mm256_unpacklo_epi64(t1, t3);
  __m256i u3 = _mm256_unpackhi_epi64(t1, t3);
  __m256i u4 = _mm256_unpacklo_epi64(t4, t6);
  __m256i u5 = _mm256_unpackhi_epi64(t4, t6);
  __m256i u6 = _mm256_unpacklo_epi64(t5, t7);
  __m256i u7 = _mm256_unpackhi_epi64(t5, t7);
  _mm256_storeu_si256((__m256i*)b[0], _mm256_permute2x128_si256(u0, u4, 0x20));
  _mm256_storeu_si256((__m256i*)b[1], _mm256_permute2x128_si256(u1, u5, 0x20));
  _mm256_storeu_si256((__m256i*)b[2], _mm256_permute2x128_si256(u2, u6, 0x20));
  _mm256_storeu_si256((__m256i*)b[3], _mm256_permute2x128_si256(u3, u7, 0x20));
  _mm256_storeu_si256((__m256i*)b[4], _mm256_permute2x128_si256(u0, u4, 0x31));
  _mm256_storeu_si256((__m256i*)b[5], _mm256_permute2x128_si256(u1, u5, 0x31));
  _mm256_storeu_si256((__m256i*)b[6], _mm256_permute2x128_si256(u2, u6, 0x31));
  _mm256_storeu_si256((__m256i*)b[7], _mm256_permute2x128_si256(u3, u7, 0x31));
#else
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) b[j][i] = a[i][j];
#endif
}

}  // namespace jdct

extern "C" {

// plane [h, w] raw samples -> out [ceil(h/8)*ceil(w/8)*64] int32 zigzag
// quantized blocks (row-major block order), edge-replicated pad.
// Integer islow: row pass along x, column pass along y, round-half-away
// /8q quantizer (reference encoder.go:440-468 semantics).
// src_type: 0 = int32, 1 = uint8, 2 = uint16 (native-endian)
}  // extern "C"

namespace {

// Shared frame-encode DCT context: padded-copy management, quant magic
// constants, and the per-block register pipeline producing zigzag
// quantized coefficients.  Used by jpg_fdct_quant (two-phase path) and
// jpg_encode_frame (fused DCT+quant+Huffman, gray fast path).
struct JFdct {
  const uint8_t* plane;
  int src_type, w, h, nbx, nby, pw, ph, level_shift;
  bool p12, aligned;
  std::vector<int32_t> src;
  // Division by the invariant d=8q via exact magic multiply
  // (Granlund-Montgomery): with s = 20 + ceil(log2 d) and
  // m = floor(2^s/d)+1, floor(n*m >> s) == floor(n/d) for all
  // 0 <= n < 2^19 — and |coef|+4q < 2^19 always (the final descale
  // bounds |coef| <= 2^17 even for wrapped adversarial inputs; q is
  // clamped to [1, 65535]).
  alignas(32) int32_t qd[64];
  alignas(32) int32_t qhalf[64];
  alignas(32) uint32_t qmag[64];
  alignas(32) uint32_t qsh[64];
  double qinv[64];

  bool init(const uint8_t* plane_, int src_type_, int w_, int h_,
            const int32_t* q64, int level_shift_) {
    plane = plane_;
    src_type = src_type_;
    w = w_;
    h = h_;
    level_shift = level_shift_;
    if (w <= 0 || h <= 0) return false;
    nbx = (w + 7) / 8;
    nby = (h + 7) / 8;
    pw = nbx * 8;
    ph = nby * 8;
    p12 = level_shift >= 1024;  // ops/dct_int.pass1_bits
    // edge-replicated, level-shifted int32 copy (branch-free inner
    // loops); skipped entirely for 8-aligned images — blocks load
    // straight from the source rows
    aligned = (w % 8 == 0) && (h % 8 == 0);
    if (!aligned) {
      src.resize((size_t)ph * pw);
      for (int y = 0; y < ph; y++) {
        int sy = y < h ? y : h - 1;
        int32_t* drow = src.data() + (size_t)y * pw;
        if (src_type == 1) {
          const uint8_t* row = plane + (long)sy * w;
          for (int x = 0; x < w; x++)
            drow[x] = (int32_t)row[x] - level_shift;
        } else if (src_type == 2) {
          const uint16_t* row = (const uint16_t*)plane + (long)sy * w;
          for (int x = 0; x < w; x++)
            drow[x] = (int32_t)row[x] - level_shift;
        } else {
          const int32_t* row = (const int32_t*)plane + (long)sy * w;
          for (int x = 0; x < w; x++) drow[x] = row[x] - level_shift;
        }
        for (int x = w; x < pw; x++) drow[x] = drow[w - 1];
      }
    }
    for (int i = 0; i < 64; i++) {
      int32_t q = q64[i];
      if (q < 1) q = 1;
      if (q > 65535) q = 65535;
      qd[i] = q * 8;
      qhalf[i] = q * 4;
      qinv[i] = 1.0 / (double)qd[i];
      uint32_t lg = 32 - __builtin_clz((uint32_t)qd[i] - 1);
      qsh[i] = 20 + lg;
      qmag[i] = (uint32_t)((((uint64_t)1 << qsh[i]) / (uint32_t)qd[i]) + 1);
    }
    return true;
  }

  // One block -> zigzag quantized coefficients qs[64].  If nzraster is
  // non-null it receives the RASTER-order nonzero bitmask computed from
  // the quant vectors (so callers avoid wide reloads of the freshly
  // scalar-scattered qs — a store-forwarding stall).
  void block_zz(int by, int bx, int32_t* qs,
                uint64_t* nzraster = nullptr,
                bool raster_out = false) const {
    const int32_t* band =
        aligned ? nullptr : src.data() + (size_t)by * 8 * pw;
#if defined(__AVX2__)
    // register-resident pipeline: load -> transpose -> pass1 ->
    // transpose -> pass2 -> quant without touching memory in between
    jdct::avx::V r[8], o[8];
    const jdct::avx::V lvl = _mm256_set1_epi32(level_shift);
    if (aligned && src_type == 1) {
      const uint8_t* p0 = plane + ((long)by * 8) * w + bx * 8;
      for (int y = 0; y < 8; y++)
        r[y] = _mm256_sub_epi32(
            _mm256_cvtepu8_epi32(
                _mm_loadl_epi64((const __m128i*)(p0 + (long)y * w))),
            lvl);
    } else if (aligned && src_type == 2) {
      const uint16_t* p0 =
          (const uint16_t*)plane + ((long)by * 8) * w + bx * 8;
      for (int y = 0; y < 8; y++)
        r[y] = _mm256_sub_epi32(
            _mm256_cvtepu16_epi32(
                _mm_loadu_si128((const __m128i*)(p0 + (long)y * w))),
            lvl);
    } else if (aligned) {
      const int32_t* p0 =
          (const int32_t*)plane + ((long)by * 8) * w + bx * 8;
      for (int y = 0; y < 8; y++)
        r[y] = _mm256_sub_epi32(
            _mm256_loadu_si256((const __m256i*)(p0 + (long)y * w)), lvl);
    } else {
      for (int y = 0; y < 8; y++)
        r[y] = _mm256_loadu_si256(
            (const __m256i*)(band + (size_t)y * pw + bx * 8));
    }
    jdct::avx::transpose(r);                       // [x] lanes y
    if (p12) jdct::avx::fdct_pass<false, 1>(r, o); // [u] lanes y
    else     jdct::avx::fdct_pass<false, 2>(r, o);
    jdct::avx::transpose(o);                       // [y] lanes u
    if (p12) jdct::avx::fdct_pass<true, 1>(o, r);  // [v] lanes u
    else     jdct::avx::fdct_pass<true, 2>(o, r);
    // fused quant: |c|+4q, magic-multiply exact /8q, sign restore
    alignas(32) int32_t qr[64];
    for (int v = 0; v < 8; v++) {
      jdct::avx::V c = r[v];
      jdct::avx::V half = _mm256_load_si256((const __m256i*)(qhalf + v * 8));
      jdct::avx::V mag = _mm256_load_si256((const __m256i*)(qmag + v * 8));
      jdct::avx::V sh = _mm256_load_si256((const __m256i*)(qsh + v * 8));
      jdct::avx::V neg = _mm256_srai_epi32(c, 31);
      jdct::avx::V n = _mm256_add_epi32(
          _mm256_sub_epi32(_mm256_xor_si256(c, neg), neg), half);
      jdct::avx::V lo = _mm256_srlv_epi64(
          _mm256_mul_epu32(n, mag),
          _mm256_blend_epi32(sh, _mm256_setzero_si256(), 0xAA));
      jdct::avx::V hi = _mm256_srlv_epi64(
          _mm256_mul_epu32(_mm256_srli_epi64(n, 32),
                           _mm256_srli_epi64(mag, 32)),
          _mm256_srli_epi64(sh, 32));
      jdct::avx::V t =
          _mm256_blend_epi32(lo, _mm256_slli_epi64(hi, 32), 0xAA);
      t = _mm256_sub_epi32(_mm256_xor_si256(t, neg), neg);
      _mm256_store_si256((__m256i*)(qr + v * 8), t);
    }
    if (nzraster) {
      uint64_t m = 0;
      const __m256i zero = _mm256_setzero_si256();
      for (int v = 0; v < 8; v++) {
        int zb = _mm256_movemask_ps(_mm256_castsi256_ps(_mm256_cmpeq_epi32(
            _mm256_load_si256((const __m256i*)(qr + v * 8)), zero)));
        m |= (uint64_t)(~zb & 0xFF) << (v * 8);
      }
      *nzraster = m;
      if (raster_out) {
        // fused-frame fast path: the scan walker indexes through
        // jdct::ZZ itself, so the 64-wide zigzag scatter (64 scalar
        // loads+stores for ~19 read coefficients) is skipped
        memcpy(qs, qr, sizeof(qr));
        return;
      }
    }
    for (int i = 0; i < 64; i++) qs[i] = qr[jdct::ZZ[i]];
#else
    alignas(32) int32_t f[64];
    int32_t blk[8][8], bt[8][8], t1[8][8], t2[8][8];
    int32_t(*f8)[8] = (int32_t(*)[8])f;
    if (aligned) {
      // direct level-shifted load from the source rows
      if (src_type == 1) {
        const uint8_t* p0 = plane + ((long)by * 8) * w + bx * 8;
        for (int y = 0; y < 8; y++)
          for (int x = 0; x < 8; x++)
            blk[y][x] = (int32_t)p0[(long)y * w + x] - level_shift;
      } else if (src_type == 2) {
        const uint16_t* p0 =
            (const uint16_t*)plane + ((long)by * 8) * w + bx * 8;
        for (int y = 0; y < 8; y++)
          for (int x = 0; x < 8; x++)
            blk[y][x] = (int32_t)p0[(long)y * w + x] - level_shift;
      } else {
        const int32_t* p0 =
            (const int32_t*)plane + ((long)by * 8) * w + bx * 8;
        for (int y = 0; y < 8; y++)
          for (int x = 0; x < 8; x++)
            blk[y][x] = p0[(long)y * w + x] - level_shift;
      }
    } else {
      for (int y = 0; y < 8; y++)
        memcpy(blk[y], band + (size_t)y * pw + bx * 8,
               8 * sizeof(int32_t));
    }
    // pass 1 along x: lanes over y -> t1[u][y]
    jdct::transpose8(blk, bt);             // bt[x][y]
    if (p12) jdct::fdct_pass<false, 1>(bt, t1);   // t1[u][y]
    else     jdct::fdct_pass<false, 2>(bt, t1);
    // pass 2 along y: lanes over u -> f[v][u]
    jdct::transpose8(t1, t2);              // t2[y][u]
    if (p12) jdct::fdct_pass<true, 1>(t2, f8);    // f[v][u]
    else     jdct::fdct_pass<true, 2>(t2, f8);
    // branchless exact quant: t = floor((|c|+4q)/8q) via double
    // reciprocal + one-step fixup, then sign restore; vectorizable.
    int32_t qr[64];
    for (int i = 0; i < 64; i++) {
      int32_t c = f[i];
      int32_t neg = -(int32_t)(c < 0);
      int32_t n = (c ^ neg) - neg + qhalf[i];  // |c| + 4q
      int32_t t = (int32_t)((double)n * qinv[i]);
      t -= (int32_t)(t * qd[i] > n);
      t += (int32_t)((t + 1) * qd[i] <= n);
      qr[i] = (t ^ neg) - neg;
    }
    if (nzraster) {
      uint64_t m = 0;
      for (int k = 0; k < 64; k++)
        if (qr[k]) m |= 1ull << k;
      *nzraster = m;
      if (raster_out) {  // see the AVX2 branch
        memcpy(qs, qr, sizeof(qr));
        return;
      }
    }
    for (int i = 0; i < 64; i++) qs[i] = qr[jdct::ZZ[i]];
#endif
  }
};

// raster nonzero mask -> zigzag nonzero mask, byte-sliced LUT:
// zz bit i is set iff raster bit ZZ[i] is set.
struct ZZMaskLut {
  uint64_t t[8][256];
  ZZMaskLut() {
    int inv[64];
    for (int i = 0; i < 64; i++) inv[jdct::ZZ[i]] = i;
    for (int v = 0; v < 8; v++)
      for (int b = 0; b < 256; b++) {
        uint64_t m = 0;
        for (int x = 0; x < 8; x++)
          if (b & (1 << x)) m |= 1ull << inv[v * 8 + x];
        t[v][b] = m;
      }
  }
  uint64_t operator()(uint64_t raster) const {
    uint64_t m = 0;
    for (int v = 0; v < 8; v++)
      m |= t[v][(raster >> (v * 8)) & 0xFF];
    return m;
  }
};
const ZZMaskLut ZZMASK;

}  // namespace

extern "C" {

// plane [h, w] raw samples -> out [ceil(h/8)*ceil(w/8)*64] int32 zigzag
// quantized blocks (row-major block order), edge-replicated pad.
// Integer islow: row pass along x, column pass along y, round-half-away
// /8q quantizer (reference encoder.go:440-468 semantics).
// src_type: 0 = int32, 1 = uint8, 2 = uint16 (native-endian)
int jpg_fdct_quant(const uint8_t* plane, int src_type, int w, int h,
                   const int32_t* q64, int level_shift, int32_t* out) {
  JFdct ctx;
  if (!ctx.init(plane, src_type, w, h, q64, level_shift)) return -1;
  for (int by = 0; by < ctx.nby; by++)
    for (int bx = 0; bx < ctx.nbx; bx++)
      ctx.block_zz(by, bx, out + ((long)by * ctx.nbx + bx) * 64);
  return 0;
}

// Fused single-component frame encoder: per-block DCT+quant feeding the
// Huffman scan writer directly — the coefficient block never leaves L1
// and the 1 MB zigzag buffer round trip of the two-phase path is gone.
// Gray, no restart markers (the adapter falls back otherwise).
// Returns scan bytes written (FF-stuffed, 1-padded), or -1.
long jpg_encode_frame(const uint8_t* plane, int src_type, int w, int h,
                      const int32_t* q64, int level_shift,
                      const int32_t* dc_codes, const int32_t* dc_lens,
                      const int32_t* ac_codes, const int32_t* ac_lens,
                      uint8_t* out, long out_cap) {
  JFdct ctx;
  if (!ctx.init(plane, src_type, w, h, q64, level_shift)) return -1;
  long nblocks = (long)ctx.nby * ctx.nbx;
  std::unique_ptr<uint8_t[]> raw(
      new uint8_t[(size_t)nblocks * 64 * 4 + 64]);  // uninit POD
  uint8_t* rp = raw.get();
  size_t ro = 0;
  uint64_t acc = 0;
  int nacc = 0;
  auto put = [&](uint64_t v, int len) {
    if (!len) return;
    acc |= (v & ((1ull << len) - 1)) << (64 - nacc - len);
    nacc += len;
    uint64_t wv = __builtin_bswap64(acc);
    memcpy(rp + ro, &wv, 8);
    int nb = nacc >> 3;
    ro += nb;
    acc <<= nb * 8;
    nacc &= 7;
  };
  // branchless per-symbol emission: every symbol goes straight through
  // the unconditional 8-byte put (nacc stays <= 7, max symbol is 32
  // bits, so nacc+len <= 39 < 64 always).  A batching pv/pl layer with
  // an overflow-check flush branch measured the SAME (the scan is not
  // emission-bound); the simpler direct form is kept.
  auto emit = [&](uint64_t v, int len) { put(v, len); };
  // packed (code << 5 | len) tables: the per-symbol length-presence
  // check becomes a test on the already-loaded entry instead of a
  // second dependent table load (lens <= 16 fit in 5 bits)
  uint32_t dcp[17], acp[256];
  for (int i = 0; i < 17; i++)
    dcp[i] = ((uint32_t)dc_codes[i] << 5) | ((uint32_t)dc_lens[i] & 31);
  for (int i = 0; i < 256; i++)
    acp[i] = ((uint32_t)ac_codes[i] << 5) | ((uint32_t)ac_lens[i] & 31);
  const uint32_t pZRL = acp[0xF0], pEOB = acp[0];
  // two alternating coefficient buffers: block i+1's DCT stores never
  // alias block i's scan reads, so the OOO window can overlap the DCT
  // chain of the next block with the Huffman walk of the current one
  alignas(32) int32_t blk2[2][64];
  int parity = 0;
  int64_t prev_dc = 0;
  for (int by = 0; by < ctx.nby; by++) {
    for (int bx = 0; bx < ctx.nbx; bx++) {
      int32_t* blk = blk2[parity];
      parity ^= 1;
      uint64_t rmask = 0;
      ctx.block_zz(by, bx, blk, &rmask, true);
      int64_t diff = (int64_t)blk[0] - prev_dc;
      prev_dc = blk[0];
      int cat = jpg_cat(diff);
      // |quantized coef| <= 2^14 (JFdct descale bound / 8q), so
      // |diff| <= 2^15 and cat <= 16; the guard keeps any analysis
      // gap on the -1 path instead of an OOB read
      if (cat > 16) return -1;
      uint32_t dp = dcp[cat];
      int dl = (int)(dp & 31);
      if (!dl) return -1;
      if (cat && cat != 16) {
        uint32_t eb = (uint32_t)(diff < 0 ? diff + (1 << cat) - 1 : diff) &
                      ((1u << cat) - 1);
        emit(((uint64_t)(dp >> 5) << cat) | eb, dl + cat);
      } else {
        emit(dp >> 5, dl);
      }
      int last_nz = 0;
      uint64_t m = ZZMASK(rmask) & ~1ull;
      while (m) {
        int k2 = __builtin_ctzll(m);
        m &= m - 1;
        int run = k2 - last_nz - 1;
        while (run >= 16) {
          if (!(pZRL & 31)) return -1;
          emit(pZRL >> 5, pZRL & 31);
          run -= 16;
        }
        int32_t v = blk[jdct::ZZ[k2]];
        int32_t sgn = v >> 31;
        uint32_t a = (uint32_t)((v ^ sgn) - sgn);
        int ac = 32 - __builtin_clz(a);
        uint32_t p = acp[(run << 4) | ac];
        int cl = (int)(p & 31);
        if (!cl) return -1;
        uint32_t aeb = (uint32_t)(v + (sgn & (int32_t)((1u << ac) - 1))) &
                       ((1u << ac) - 1);
        emit(((uint64_t)(p >> 5) << ac) | aeb, cl + ac);
        last_nz = k2;
      }
      if (last_nz < 63) {
        if (!(pEOB & 31)) return -1;
        emit(pEOB >> 5, pEOB & 31);
      }
    }
  }
  if (nacc) {
    int fill = 8 - nacc;
    put((1u << fill) - 1, fill);
  }
  // FF -> FF 00 stuffing
  long o = 0;
  size_t i = 0;
  while (i < ro) {
    const uint8_t* ff = (const uint8_t*)memchr(rp + i, 0xFF, ro - i);
    size_t run = ff ? (size_t)(ff - (rp + i)) : ro - i;
    if (o + (long)run + 2 > out_cap) return -1;
    memcpy(out + o, rp + i, run);
    o += run;
    i += run;
    if (ff) {
      out[o++] = 0xFF;
      out[o++] = 0x00;
      i++;
    }
  }
  return o;
}

// zz [nby*nbx, 64] int32 zigzag -> out plane [nby*8, nbx*8] int32 clamped
// to [0, max_val] after fused dequant + integer islow IDCT + level shift.
int jpg_idct(const int32_t* zz, int nby, int nbx, const int32_t* q64,
             int level_shift, int max_val, int32_t* out) {
  if (nbx <= 0 || nby <= 0) return -1;
  long w = (long)nbx * 8;
  const bool p12 = level_shift >= 1024;  // ops/dct_int.pass1_bits
  for (int by = 0; by < nby; by++) {
    for (int bx = 0; bx < nbx; bx++) {
      const int32_t* src = zz + ((long)by * nbx + bx) * 64;
      alignas(32) int32_t f[64];
      // dequant at zigzag scatter -> f[v][u] raster; the 12-bit profile
      // halves (round-half-up) for int32 headroom, compensated in the
      // final descale (idct_pass<true, 0>)
      for (int i = 0; i < 64; i++)
        f[jdct::ZZ[i]] = src[i] * q64[jdct::ZZ[i]];
      if (p12)
        for (int i = 0; i < 64; i++) f[i] = (f[i] + 1) >> 1;
      // auto-vectorized passes (measured FASTER than a register-resident
      // AVX2 pipeline here: the scalar zigzag scatter right above makes
      // wide vector loads of f stall on store-forwarding)
      int32_t w1[8][8], w2[8][8], s[8][8], st[8][8];
      int32_t(*f8)[8] = (int32_t(*)[8])f;
      // pass 1 along v: lanes over u (raster rows are already vectors)
      if (p12) jdct::idct_pass<false, 1>(f8, w1);   // w1[y][u]
      else     jdct::idct_pass<false, 2>(f8, w1);
      // pass 2 along u: lanes over y
      jdct::transpose8(w1, w2);              // w2[u][y]
      if (p12) jdct::idct_pass<true, 0>(w2, s);     // s[x][y]
      else     jdct::idct_pass<true, 2>(w2, s);
      jdct::transpose8(s, st);               // st[y][x]
      for (int y = 0; y < 8; y++) {
        int32_t* dst = out + ((long)by * 8 + y) * w + (long)bx * 8;
        for (int x = 0; x < 8; x++) {
          int32_t v = st[y][x] + level_shift;
          v = v < 0 ? 0 : v;
          v = v > max_val ? max_val : v;
          dst[x] = v;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"

// ============================================================================
// Irreversible 9/7 float DWT host fast path — mirror in role of
// ops/dwt97.py (OpenJPEG-style float32 lifting, parity-aware windows).
// float32 like the XLA path but NOT bit-pinned against it: lossy-stage
// values may differ in the last ulp (tolerance-tested), same policy as
// the JPEG DCT host path above.
// ============================================================================

namespace w97 {

const float ALPHA = -1.586134342f, BETA = -0.052980118f,
            GAMMA = 0.882911075f, DELTA = 0.443506852f,
            KK = 1.230174105f, INV_K = 0.812893066f;

inline int iclamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// one (predict, update) lifting pair on deinterleaved s[sn], d[dn]
// (ops/dwt97.py _predict_update clamp semantics)
inline void pair_line(float* s, float* d, int sn, int dn, bool even,
                      float cp, float cu) {
  if (even) {
    if (cp != 0.0f)
      for (int i = 0; i < dn; i++)
        d[i] += cp * (s[i] + s[iclamp(i + 1, 0, sn - 1)]);
    if (cu != 0.0f)
      for (int i = 0; i < sn; i++)
        s[i] += cu * (d[iclamp(i - 1, 0, dn - 1)] + d[iclamp(i, 0, dn - 1)]);
  } else {
    if (cp != 0.0f)
      for (int i = 0; i < dn; i++)
        d[i] += cp * (s[iclamp(i - 1, 0, sn - 1)] + s[iclamp(i, 0, sn - 1)]);
    if (cu != 0.0f)
      for (int i = 0; i < sn; i++)
        s[i] += cu * (d[i] + d[iclamp(i + 1, 0, dn - 1)]);
  }
}

// forward 1D along a row -> packed [L | H] in place
void f97_line(float* x, int n, bool even, float* tmp) {
  if (n <= 1) return;
  int sn = even ? (n + 1) / 2 : n / 2;
  int dn = n - sn;
  float* s = tmp;
  float* d = tmp + sn;
  if (even) {
    for (int i = 0; i < sn; i++) s[i] = x[2 * i];
    for (int i = 0; i < dn; i++) d[i] = x[2 * i + 1];
  } else {
    for (int i = 0; i < dn; i++) d[i] = x[2 * i];
    for (int i = 0; i < sn; i++) s[i] = x[2 * i + 1];
  }
  pair_line(s, d, sn, dn, even, ALPHA, BETA);
  pair_line(s, d, sn, dn, even, GAMMA, DELTA);
  for (int i = 0; i < sn; i++) x[i] = s[i] * INV_K;
  for (int i = 0; i < dn; i++) x[sn + i] = d[i] * KK;
}

// inverse 1D from packed [L | H]
void i97_line(float* x, int n, bool even, float* tmp) {
  if (n <= 1) return;
  int sn = even ? (n + 1) / 2 : n / 2;
  int dn = n - sn;
  float* s = tmp;
  float* d = tmp + sn;
  for (int i = 0; i < sn; i++) s[i] = x[i] * KK;
  for (int i = 0; i < dn; i++) d[i] = x[sn + i] * INV_K;
  pair_line(s, d, sn, dn, even, 0.0f, -DELTA);
  pair_line(s, d, sn, dn, even, -GAMMA, -BETA);
  pair_line(s, d, sn, dn, even, -ALPHA, 0.0f);
  if (even) {
    for (int i = 0; i < sn; i++) x[2 * i] = s[i];
    for (int i = 0; i < dn; i++) x[2 * i + 1] = d[i];
  } else {
    for (int i = 0; i < dn; i++) x[2 * i] = d[i];
    for (int i = 0; i < sn; i++) x[2 * i + 1] = s[i];
  }
}

// row-wise vertical pair (deinterleaved row planes s/d in scratch)
inline void pair_vert(float* s, float* d, int sn, int dn, int w,
                      bool even, float cp, float cu) {
  auto S = [&](int i) { return s + (size_t)iclamp(i, 0, sn - 1) * w; };
  auto D = [&](int i) { return d + (size_t)iclamp(i, 0, dn - 1) * w; };
  if (even) {
    if (cp != 0.0f)
      for (int i = 0; i < dn; i++) {
        float* o = d + (size_t)i * w;
        const float* a = S(i);
        const float* b = S(i + 1);
        for (int x = 0; x < w; x++) o[x] += cp * (a[x] + b[x]);
      }
    if (cu != 0.0f)
      for (int i = 0; i < sn; i++) {
        float* o = s + (size_t)i * w;
        const float* a = D(i - 1);
        const float* b = D(i);
        for (int x = 0; x < w; x++) o[x] += cu * (a[x] + b[x]);
      }
  } else {
    if (cp != 0.0f)
      for (int i = 0; i < dn; i++) {
        float* o = d + (size_t)i * w;
        const float* a = S(i - 1);
        const float* b = S(i);
        for (int x = 0; x < w; x++) o[x] += cp * (a[x] + b[x]);
      }
    if (cu != 0.0f)
      for (int i = 0; i < sn; i++) {
        float* o = s + (size_t)i * w;
        const float* a = d + (size_t)i * w;  // d[i], i < sn <= dn
        const float* b = D(i + 1);
        for (int x = 0; x < w; x++) o[x] += cu * (a[x] + b[x]);
      }
  }
}

void f97_vert(float* a, int h, int w, long stride, bool even,
              std::vector<float>& scratch) {
  if (h <= 1) return;
  int sn = even ? (h + 1) / 2 : h / 2;
  int dn = h - sn;
  scratch.resize((size_t)h * w);
  float* s = scratch.data();
  float* d = scratch.data() + (size_t)sn * w;
  auto row = [&](int y) { return a + (size_t)y * stride; };
  if (even) {
    for (int i = 0; i < sn; i++)
      memcpy(s + (size_t)i * w, row(2 * i), sizeof(float) * w);
    for (int i = 0; i < dn; i++)
      memcpy(d + (size_t)i * w, row(2 * i + 1), sizeof(float) * w);
  } else {
    for (int i = 0; i < dn; i++)
      memcpy(d + (size_t)i * w, row(2 * i), sizeof(float) * w);
    for (int i = 0; i < sn; i++)
      memcpy(s + (size_t)i * w, row(2 * i + 1), sizeof(float) * w);
  }
  pair_vert(s, d, sn, dn, w, even, w97::ALPHA, w97::BETA);
  pair_vert(s, d, sn, dn, w, even, w97::GAMMA, w97::DELTA);
  for (int i = 0; i < sn; i++) {
    float* o = row(i);
    const float* p = s + (size_t)i * w;
    for (int x = 0; x < w; x++) o[x] = p[x] * INV_K;
  }
  for (int i = 0; i < dn; i++) {
    float* o = row(sn + i);
    const float* p = d + (size_t)i * w;
    for (int x = 0; x < w; x++) o[x] = p[x] * KK;
  }
}

void i97_vert(float* a, int h, int w, long stride, bool even,
              std::vector<float>& scratch) {
  if (h <= 1) return;
  int sn = even ? (h + 1) / 2 : h / 2;
  int dn = h - sn;
  scratch.resize((size_t)h * w);
  float* s = scratch.data();
  float* d = scratch.data() + (size_t)sn * w;
  auto row = [&](int y) { return a + (size_t)y * stride; };
  for (int i = 0; i < sn; i++) {
    const float* p = row(i);
    float* o = s + (size_t)i * w;
    for (int x = 0; x < w; x++) o[x] = p[x] * KK;
  }
  for (int i = 0; i < dn; i++) {
    const float* p = row(sn + i);
    float* o = d + (size_t)i * w;
    for (int x = 0; x < w; x++) o[x] = p[x] * INV_K;
  }
  pair_vert(s, d, sn, dn, w, even, 0.0f, -DELTA);
  pair_vert(s, d, sn, dn, w, even, -GAMMA, -BETA);
  pair_vert(s, d, sn, dn, w, even, -ALPHA, 0.0f);
  if (even) {
    for (int i = 0; i < sn; i++)
      memcpy(row(2 * i), s + (size_t)i * w, sizeof(float) * w);
    for (int i = 0; i < dn; i++)
      memcpy(row(2 * i + 1), d + (size_t)i * w, sizeof(float) * w);
  } else {
    for (int i = 0; i < dn; i++)
      memcpy(row(2 * i), d + (size_t)i * w, sizeof(float) * w);
    for (int i = 0; i < sn; i++)
      memcpy(row(2 * i + 1), s + (size_t)i * w, sizeof(float) * w);
  }
}

}  // namespace w97

extern "C" {

// In-place multilevel forward 9/7 on float32 [height x width]
// (stride == width). Mirror in role of ops/dwt97.fwd97_multilevel.
int dwt97_fwd(float* data, int width, int height, int levels, int x0,
              int y0) {
  if (width <= 0 || height <= 0) return 0;
  std::vector<std::array<int, 4>> wins;
  dwt_windows(width, height, levels, x0, y0, wins);
  std::vector<float> scratch, line;
  for (auto& win : wins) {
    int w = win[0], h = win[1];
    bool even_row = win[2] % 2 == 0, even_col = win[3] % 2 == 0;
    if (h > 1) w97::f97_vert(data, h, w, width, even_col, scratch);
    if (w > 1) {
      line.resize((size_t)w);
      for (int y = 0; y < h; y++)
        w97::f97_line(data + (size_t)y * width, w, even_row, line.data());
    }
  }
  return 0;
}

// In-place multilevel inverse 9/7.
int dwt97_inv(float* data, int width, int height, int levels, int x0,
              int y0) {
  if (width <= 0 || height <= 0) return 0;
  std::vector<std::array<int, 4>> wins;
  dwt_windows(width, height, levels, x0, y0, wins);
  std::vector<float> scratch, line;
  for (auto it = wins.rbegin(); it != wins.rend(); ++it) {
    int w = (*it)[0], h = (*it)[1];
    bool even_row = (*it)[2] % 2 == 0, even_col = (*it)[3] % 2 == 0;
    if (w > 1) {
      line.resize((size_t)w);
      for (int y = 0; y < h; y++)
        w97::i97_line(data + (size_t)y * width, w, even_row, line.data());
    }
    if (h > 1) w97::i97_vert(data, h, w, width, even_col, scratch);
  }
  return 0;
}

}  // extern "C"
