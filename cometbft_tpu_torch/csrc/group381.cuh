// Thread groups for the BLS kernels B2 and B5 (bls12381.cu), over
// tower381.cuh: the Fp2 and Fp12 operations of one lane split across a few
// threads of a warp, as the verify kernels split a point operation across a
// quad (quad25519.cuh).
//
// Every thread of a group holds the lane's whole state and does most of its
// additions itself; the products are split, each thread computing one part
// and publishing it to the others. B2 runs trios (N = 3): an Fp2 product
// (Karatsuba) is three Fp products, one a thread. B5 runs sextets (N = 6):
// an Fp12 product (Karatsuba over Fp6 over Fp2) is 18 Fp2 products, three a
// thread; a cyclotomic square (Granger and Scott 2010) six Fp2 products,
// one a thread. The threads run the same instructions on different
// operands: a warp issues one stream for all its groups, so a lane's chain
// of products is as long as one thread's share.
//
// A group type G has N (1, 3 or 6), t (this thread's index) and, for N > 1,
// at(j) (the exchange slot of thread j) and sync() (wait for the group);
// parity selects one of two slot sets, so one sync an exchange suffices. On
// the card the group is N lanes of a warp, its slots in shared memory and
// its sync __syncwarp over its lanes; tests/test_torch_bls_formulas.py runs
// the same code on host threads and a barrier. With N = 1 (solo) each
// operation runs its parts in turn: the per-lane bodies that
// tests/test_torch_bls_host.py builds and the one-lane kernels run.

#pragma once

#include "tower381.cuh"

namespace bls {

// one thread doing a lane's work alone
struct solo {
  static constexpr int N = 1;
  int t = 0;
  __device__ __forceinline__ void sync() {}
};

#ifdef __CUDACC__
// N lanes of a warp (a trio, N = 3; a sextet, N = 6); slot words of shared
// memory a lane, two sets
template <int NN>
struct lanes_of {
  static constexpr int N = NN;
  int t;          // 0 .. N - 1
  unsigned mask;  // the group's lanes
  uint32_t* buf;  // 2 x N x slot words
  int slot;
  int parity;
  __device__ __forceinline__ uint32_t* at(int j) { return buf + (parity * N + j) * slot; }
  __device__ __forceinline__ void sync() { __syncwarp(mask); }
};
using trio = lanes_of<3>;
using sextet = lanes_of<6>;

// the lanes of a warp that share one piece of work
struct lanes_group {
  unsigned mask;
  __device__ __forceinline__ void sync() { __syncwarp(mask); }
};
#endif

template <class V>
constexpr int nwords = (int)(sizeof(V) / 4);

template <class V>
__device__ __forceinline__ const uint32_t* words_of(const V& v) {
  return reinterpret_cast<const uint32_t*>(&v);
}

template <class V>
__device__ __forceinline__ void from_words(V& o, const uint32_t* w) {
  uint32_t* d = reinterpret_cast<uint32_t*>(&o);
  for (int i = 0; i < nwords<V>; ++i) d[i] = w[i];
}

// publish n words; after the group's sync the peers' words are at g.at(j)
// until this thread's next exchange
template <class G>
__device__ __forceinline__ void tr_put(G& g, const uint32_t* w, int n) {
  g.parity ^= 1;
  uint32_t* d = g.at(g.t);
  for (int i = 0; i < n; ++i) d[i] = w[i];
  g.sync();
}

// o = x y in Fp2; on a trio thread t computes x.a y.a, x.b y.b or
// (x.a + x.b)(y.a + y.b). o may alias x or y.
template <class G>
__device__ BLS_NOINLINE void g2_mul(fp2& o, const fp2& x, const fp2& y, G& g) {
  if constexpr (G::N == 1) {
    f2_mul(o, x, y);
  } else {
    static_assert(G::N == 3, "an Fp2 product splits over three lanes");
    fp xs, ys, p;
    fp_add(xs, x.a, x.b);
    fp_add(ys, y.a, y.b);
    fp_sel(xs, g.t == 0, x.a, g.t == 1 ? x.b : xs);
    fp_sel(ys, g.t == 0, y.a, g.t == 1 ? y.b : ys);
    fp_mul(p, xs, ys);
    tr_put(g, p.v, nwords<fp>);
    fp p0, p1, p2;
    from_words(p0, g.at(0));
    from_words(p1, g.at(1));
    from_words(p2, g.at(2));
    fp_sub(o.a, p0, p1);
    fp_sub(p2, p2, p0);
    fp_sub(o.b, p2, p1);
  }
}

// o = x^2 in Fp2: thread 0 computes (a + b)(a - b), threads 1 and 2 a b
template <class G>
__device__ BLS_NOINLINE void g2_sq(fp2& o, const fp2& x, G& g) {
  if constexpr (G::N == 1) {
    f2_sq(o, x);
  } else {
    static_assert(G::N == 3, "an Fp2 square splits over three lanes");
    fp s, d, p;
    fp_add(s, x.a, x.b);
    fp_sub(d, x.a, x.b);
    fp_sel(s, g.t == 0, s, x.a);
    fp_sel(d, g.t == 0, d, x.b);
    fp_mul(p, s, d);
    tr_put(g, p.v, nwords<fp>);
    fp p0, p1;
    from_words(p0, g.at(0));
    from_words(p1, g.at(1));
    o.a = p0;
    fp_dbl(o.b, p1);
  }
}

// o = a b in Fp12 (Karatsuba over Fp6, each Fp6 product Karatsuba over
// Fp2: 18 Fp2 products). On a sextet lane 2m + h takes the Fp6 product m
// (a.d0 b.d0, a.d1 b.d1, (a.d0 + a.d1)(b.d0 + b.d1)) and its Fp2 products
// x_i y_i (h = 0) or (x_j + x_k)(y_j + y_k) (h = 1), three each; the pair
// forms m, then every lane o. o may alias a or b.
template <class G>
__device__ BLS_NOINLINE void g12_mul(fp12& o, const fp12& a, const fp12& b, G& g) {
  if constexpr (G::N == 1) {
    f12_mul(o, a, b);
  } else {
    static_assert(G::N == 6, "an Fp12 product splits over six lanes");
    const int m = g.t >> 1, h = g.t & 1;
    fp6 sa, sb;
    f6_add(sa, a.d0, a.d1);
    f6_add(sb, b.d0, b.d1);
    const fp6& x = m == 0 ? a.d0 : m == 1 ? a.d1 : sa;
    const fp6& y = m == 0 ? b.d0 : m == 1 ? b.d1 : sb;
    fp2 xs, ys, p[3];
    f2_add(xs, x.c1, x.c2);
    f2_add(ys, y.c1, y.c2);
    f2_sel(xs, h, xs, x.c0);
    f2_sel(ys, h, ys, y.c0);
    f2_mul(p[0], xs, ys);
    f2_add(xs, x.c0, x.c1);
    f2_add(ys, y.c0, y.c1);
    f2_sel(xs, h, xs, x.c1);
    f2_sel(ys, h, ys, y.c1);
    f2_mul(p[1], xs, ys);
    f2_add(xs, x.c0, x.c2);
    f2_add(ys, y.c0, y.c2);
    f2_sel(xs, h, xs, x.c2);
    f2_sel(ys, h, ys, y.c2);
    f2_mul(p[2], xs, ys);
    tr_put(g, words_of(p), nwords<fp2[3]>);
    // m = (t0 + xi (u12 - t1 - t2), u01 - t0 - t1 + xi t2, u02 - t0 - t2 + t1)
    const fp2* t = reinterpret_cast<const fp2*>(g.at(2 * m));
    const fp2* u = reinterpret_cast<const fp2*>(g.at(2 * m + 1));
    fp6 r;
    fp2 s;
    f2_add(s, t[1], t[2]);
    f2_sub(r.c0, u[0], s);
    f2_mul_xi(r.c0, r.c0);
    f2_add(r.c0, r.c0, t[0]);
    f2_add(s, t[0], t[1]);
    f2_sub(r.c1, u[1], s);
    f2_mul_xi(s, t[2]);
    f2_add(r.c1, r.c1, s);
    f2_add(s, t[0], t[2]);
    f2_sub(r.c2, u[2], s);
    f2_add(r.c2, r.c2, t[1]);
    tr_put(g, words_of(r), nwords<fp6>);
    const fp6& m0 = *reinterpret_cast<const fp6*>(g.at(0));
    const fp6& m1 = *reinterpret_cast<const fp6*>(g.at(2));
    const fp6& m2 = *reinterpret_cast<const fp6*>(g.at(4));
    f6_sub(sa, m2, m0);
    f6_sub(o.d1, sa, m1);
    f6_mul_v(sb, m1);
    f6_add(o.d0, m0, sb);
  }
}

// o = a^2 for a in the cyclotomic subgroup. On a sextet lane 2k + h takes
// the Fp4 pair k and its Fp2 product x y (h = 0) or (x + y)(x + xi y)
// (h = 1); the pair forms the two coefficients that pair's square gives.
// o may alias a.
template <class G>
__device__ BLS_NOINLINE void g12_cyclo_sq(fp12& o, const fp12& a, G& g) {
  if constexpr (G::N == 1) {
    f12_cyclo_sq(o, a);
  } else {
    static_assert(G::N == 6, "a cyclotomic square splits over six lanes");
    const int k = g.t >> 1, h = g.t & 1;
    const fp2& x = cyclo_x(a, k);
    const fp2& y = cyclo_y(a, k);
    fp2 s, u, p, r[2];
    f2_add(s, x, y);
    f2_mul_xi(u, y);
    f2_add(u, u, x);
    f2_sel(s, h, s, x);
    f2_sel(u, h, u, y);
    f2_mul(p, s, u);
    tr_put(g, words_of(p), nwords<fp2>);
    // (t0, t1) = ((x + y)(x + xi y) - x y - xi x y, 2 x y)
    const fp2& xy = *reinterpret_cast<const fp2*>(g.at(2 * k));
    const fp2& q = *reinterpret_cast<const fp2*>(g.at(2 * k + 1));
    fp2 t0, t1;
    f2_sub(t0, q, xy);
    f2_mul_xi(t1, xy);
    f2_sub(t0, t0, t1);
    f2_dbl(t1, xy);
    cyclo_pair_out(r[0], r[1], a, k, t0, t1);
    tr_put(g, words_of(r), nwords<fp2[2]>);
    from_words(o.d0.c0, g.at(0));
    from_words(o.d1.c1, g.at(0) + nwords<fp2>);
    from_words(o.d0.c1, g.at(2));
    from_words(o.d1.c2, g.at(2) + nwords<fp2>);
    from_words(o.d0.c2, g.at(4));
    from_words(o.d1.c0, g.at(4) + nwords<fp2>);
  }
}

}  // namespace bls
