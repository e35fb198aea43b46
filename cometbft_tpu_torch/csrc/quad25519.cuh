// One signature on four threads (a quad) for the verify kernels
// (verify25519.cu), over the field and point code of fe32.cuh; the
// microbench's point probes (probe32.cuh) run the same quad doubling.
//
// Thread q of a quad owns coordinate q (X, Y, Z, T) of the accumulator, and
// each point operation runs its field multiplications four at a time, as
// curve25519-dalek's AVX2 backend runs the same formulas (Hisil, Wong,
// Carter, Dawson, "Twisted Edwards Curves Revisited", 2008) across four
// SIMD lanes. The quad's exchanges are the Quad type's from() (on the card
// the quad type below, __shfl_sync within the warp;
// tests/test_torch_fe32_host.py runs the same code on four host threads), so
// everything here but that type is host C++ as well.

#pragma once

#include "fe32.cuh"

namespace f32 {

constexpr int BASE_WORDS = 4 * NW * ENTRIES;  // (y - x, y + x, 2z, 2dt) of [d]B

#ifdef __CUDACC__
constexpr unsigned FULL = 0xffffffffu;

// A quad of the warp: its exchanges are shuffles within the warp, so every
// warp that holds quads must be whole.
struct quad {
  int q;     // this thread's coordinate: 0 X, 1 Y, 2 Z, 3 T
  int base;  // lane of the quad's thread 0 in the warp

  // o = a of the quad's thread j (j may differ per thread)
  __device__ __forceinline__ void from(fe& o, const fe& a, int j) const {
#pragma unroll
    for (int i = 0; i < NW; i++) o.v[i] = __shfl_sync(FULL, a.v[i], base + j);
  }
  __device__ __forceinline__ int from_int(int v, int j) const {
    return __shfl_sync(FULL, v, base + j);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

// The quad of thread `tid` of a block.
__device__ __forceinline__ quad quad_of(unsigned tid) {
  return quad{(int)(tid & 3), (int)(tid & 31 & ~3u)};
}
#endif

// Words of the quads' tables of [d](-A) for `sigs` signatures.
__host__ __device__ constexpr int table_words(int sigs) { return 4 * NW * ENTRIES * sigs; }

// The [d]B table from the wrapper's words (verify_kernel.base_table_words:
// (y - x, y + x, 2, 2dt) of each d, [coord][word][entry]) into tb as field
// elements, [coord][limb][entry]: the (coord, entry) pairs first, first +
// step, ... of the 68.
__device__ __forceinline__ void load_base_table(uint32_t* tb, const int* words, int first,
                                                int step) {
  for (int k = first; k < 4 * ENTRIES; k += step) {
    const int coord = k / ENTRIES, e = k % ENTRIES;
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; i++) w[i] = (uint32_t)words[(coord * 8 + i) * ENTRIES + e];
    fe x;
    from_words256(x, w);
#pragma unroll
    for (int i = 0; i < NW; i++) tb[(coord * NW + i) * ENTRIES + e] = (uint32_t)x.v[i];
  }
}

// o = a where c, else b, word by word
__device__ __forceinline__ void pick(fe& o, bool c, const fe& a, const fe& b) {
#pragma unroll
  for (int i = 0; i < NW; i++) o.v[i] = c ? a.v[i] : b.v[i];
}

// dbl-2008-hwcd on the quad: the squares A = X^2 (thread 0), S = (X + Y)^2
// (1), Z^2 (2), B = Y^2 (3); then X3 = E F, Y3 = G H, Z3 = F G, T3 = E H.
template <class Quad>
__device__ __forceinline__ void qdbl(fe& c, const Quad& Q) {
  fe recv, s, in, r, a, sxy, zz, b, h, e, g, f, l, rr;
  Q.from(recv, c, Q.q == 0 ? 1 : Q.q == 1 ? 0 : Q.q == 2 ? 2 : 1);
  add(s, c, recv);
  pick(in, Q.q == 1, s, c);
  pick(in, Q.q == 3, recv, in);
  sq(r, in);
  Q.from(a, r, 0);
  Q.from(sxy, r, 1);
  Q.from(zz, r, 2);
  Q.from(b, r, 3);
  add(h, a, b);
  sub(e, h, sxy);
  sub(g, a, b);
  add(f, zz, zz);
  add(f, f, g);
  pick(l, Q.q == 1, g, e);
  pick(l, Q.q == 2, f, l);
  pick(rr, Q.q == 0, f, h);
  pick(rr, Q.q == 2, g, rr);
  mul(c, l, rr);
}

// add-2008-hwcd-3 on the quad with the addend's cached component qc (Y - X,
// Y + X, 2Z or, for an affine addend, 2, and 2dT by thread): the products A
// (thread 0), B (1), D (2), C (3); then X3 = E F, Y3 = G H, Z3 = F G,
// T3 = E H.
template <class Quad>
__device__ __forceinline__ void qadd(fe& c, const Quad& Q, const fe& qc) {
  fe recv, d, s, l, r, a, b, dd, cc, e, f, g, h, rr;
  Q.from(recv, c, Q.q ^ 1);
  sub(d, recv, c);
  add(s, c, recv);
  pick(l, Q.q == 0, d, c);
  pick(l, Q.q == 1, s, l);
  mul(r, l, qc);
  Q.from(a, r, 0);
  Q.from(b, r, 1);
  Q.from(dd, r, 2);
  Q.from(cc, r, 3);
  sub(e, b, a);
  sub(f, dd, cc);
  add(g, dd, cc);
  add(h, b, a);
  pick(l, Q.q == 1, g, e);
  pick(l, Q.q == 2, f, l);
  pick(rr, Q.q == 0, f, h);
  pick(rr, Q.q == 2, g, rr);
  mul(c, l, rr);
}

// This thread's component of the cached form of the quad's point: Y - X,
// Y + X, 2Z, T * 2d.
template <class Quad>
__device__ __forceinline__ void qcached(fe& o, const fe& c, const Quad& Q) {
  fe recv, d, s, z2, t2d;
  Q.from(recv, c, Q.q ^ 1);
  sub(d, recv, c);
  add(s, c, recv);
  add(z2, c, c);
  const_d2(t2d);
  mul(t2d, c, t2d);
  pick(o, Q.q == 0, d, t2d);
  pick(o, Q.q == 1, s, o);
  pick(o, Q.q == 2, z2, o);
}

// The quads' tables of [d](-A): word (limb, entry, signature, coord) at
// table[((limb * ENTRIES + entry) * sigs + sig) * 4 + coord], so a warp's 8
// signatures x 4 coordinates read 32 banks whatever their entries.
struct quad_table {
  uint32_t* base;  // table + sig * 4
  int stride;      // sigs * 4

  __device__ __forceinline__ void load(fe& o, int coord, int entry) const {
#pragma unroll
    for (int i = 0; i < NW; i++) o.v[i] = base[(i * ENTRIES + entry) * stride + coord];
  }
  __device__ __forceinline__ void store(int coord, int entry, const fe& a) const {
#pragma unroll
    for (int i = 0; i < NW; i++) base[(i * ENTRIES + entry) * stride + coord] = a.v[i];
  }
};

// The coordinate thread q takes of entry |d|: for d < 0, Y - X and Y + X
// trade places (and 2dT changes sign).
__device__ __forceinline__ int qcoord(int q, int d) { return d < 0 && q < 2 ? q ^ 1 : q; }

template <class Quad>
__device__ __forceinline__ void qselect(fe& o, const quad_table& t, const Quad& Q, int d) {
  t.load(o, qcoord(Q.q, d), d < 0 ? -d : d);
  if (d < 0 && Q.q == 3) neg(o, o);
}

// The same of the [d]B table (load_base_table).
template <class Quad>
__device__ __forceinline__ void qselect_base(fe& o, const uint32_t* tb, const Quad& Q, int d) {
  const int e = d < 0 ? -d : d, coord = qcoord(Q.q, d);
#pragma unroll
  for (int i = 0; i < NW; i++) o.v[i] = tb[(coord * NW + i) * ENTRIES + e];
  if (d < 0 && Q.q == 3) neg(o, o);
}

// Signature b's verdict on its quad (verify_kernel.verify_math_ok /
// verify_math_sr_ok / verify_math_bench for one lane), every thread of the
// quad returning it: the table of [d](-A) in `tab`, the signed digits of s
// and k at sd / kd (stride `dstride`, written here by threads 0 and 1),
// [s]B + [k](-A) by the signed 5-bit ladder, most significant window
// first, R decoded — ZIP-215 (ed25519) or ristretto255 (sr25519) — and
// [cofactor](acc - R) == O. tb is the [d]B table.
//
// With BENCH the knobs of the Pallas kernel's bisection apply: n_windows >
// 0 runs windows n_windows-1 .. 0 only, and nodecomp takes R = A with ok
// instead of decoding R. Both give wrong verdicts.
template <int SCHEME, bool BENCH, class Quad>
__device__ __forceinline__ bool verify_quad(const Quad& Q, const int* ax, const int* ay,
                                            const int* az, const int* at, const int* rw,
                                            const int* sw, const int* kw, const uint32_t* tb,
                                            const quad_table& tab, int8_t* sd, int8_t* kd,
                                            int dstride, int b, int B, int n_windows,
                                            int nodecomp) {
  if (Q.q == 0) store_digits(sd, dstride, sw, b, B);
  if (Q.q == 1) store_digits(kd, dstride, kw, b, B);

  // [d](-A) for d = 0..16 as the plain build_point_table17 forms them (even
  // d by doubling [d/2], odd d by adding -A to [d-1]), each thread its
  // coordinate, then turned into cached form in place
  fe c, qc1;
  {
    const int* src = Q.q == 0 ? ax : Q.q == 1 ? ay : Q.q == 2 ? az : at;
    load_limbs13(c, src, b, B);
    if (Q.q == 0 || Q.q == 3) neg(c, c);
    tab.store(Q.q, 1, c);
    qcached(qc1, c, Q);
    fe id;
    if (Q.q == 1 || Q.q == 2) {
      one(id);
    } else {
      zero(id);
    }
    tab.store(Q.q, 0, id);
#pragma unroll 1
    for (int d = 2; d < ENTRIES; d++) {
      if (d % 2 == 0) {
        tab.load(c, Q.q, d / 2);
        qdbl(c, Q);
      } else {
        tab.load(c, Q.q, d - 1);
        qadd(c, Q, qc1);
      }
      tab.store(Q.q, d, c);
    }
#pragma unroll 1
    for (int d = 0; d < ENTRIES; d++) {
      tab.load(c, Q.q, d);
      qcached(c, c, Q);
      tab.store(Q.q, d, c);
    }
  }
  Q.sync();  // the digits and the other threads' table coordinates

  // per window: five quad doublings, each computing T, then the base add
  // and the -A add
  if (Q.q == 1 || Q.q == 2) {
    one(c);
  } else {
    zero(c);
  }
  const int nw = BENCH && n_windows > 0 ? n_windows : NDIG;
#pragma unroll 1
  for (int i = nw - 1; i >= 0; i--) {
#pragma unroll 1
    for (int j = 0; j < 5; j++) qdbl(c, Q);
    fe qc;
    qselect_base(qc, tb, Q, sd[i * dstride]);
    qadd(c, Q, qc);
    qselect(qc, tab, Q, kd[i * dstride]);
    qadd(c, Q, qc);
  }

  // R, decoded by every thread of the quad after the ladder (a warp issues
  // the same instructions whether one thread of each quad or all four run
  // them), then acc - R and the cofactor
  pt r;
  bool ok_r;
  if (BENCH && nodecomp) {
    load_point13(r, ax, ay, az, at, b, B);
    ok_r = true;
  } else {
    uint32_t w[8];
    load_words(w, rw, b, B);
    fe y;
    int sign;
    from_words255(y, sign, w);
    if constexpr (SCHEME == SR25519) {
      ok_r = ristretto_decode(r, y, sign);
    } else {
      ok_r = decompress(r, y, sign);
    }
  }
  {
    neg(r, r);
    cached cr;
    to_cached(cr, r);
    fe qr;
    pick(qr, Q.q == 0, cr.ymx, cr.t2d);
    pick(qr, Q.q == 1, cr.ypx, qr);
    pick(qr, Q.q == 2, cr.z2, qr);
    qadd(c, Q, qr);
  }
  constexpr int doublings = SCHEME == SR25519 ? 2 : 3;
#pragma unroll 1
  for (int i = 0; i < doublings; i++) qdbl(c, Q);

  // X == 0 (thread 0) and Y == Z (thread 1, with Z from thread 2)
  fe z, t;
  Q.from(z, c, Q.q ^ 3);
  sub(t, c, z);
  const int mine = (Q.q == 0 ? is_zero(c) : Q.q == 1 ? is_zero(t) : true) ? 1 : 0;
  const int x_zero = Q.from_int(mine, 0);
  const int y_eq_z = Q.from_int(mine, 1);
  return x_zero && y_eq_z && ok_r;
}

}  // namespace f32
