// Thread groups for the BLS kernels B1, B2, B4 and B5 (bls12381.cu), over
// tower381.cuh: the Fp2 and Fp12 operations of one lane split across a few
// threads of a warp, as the verify kernels split a point operation across a
// quad (quad25519.cuh).
//
// Every thread of a group holds the lane's whole state and does most of its
// additions itself; the products are split, each thread computing one part
// and publishing it to the others. B1 G2 and B2 run trios (N = 3): an Fp2
// product (Karatsuba) is three Fp products, one a thread; B1 G1's trios
// take a round of up to three independent Fp products of a Jacobian step
// (fp_round). B5 runs sextets
// (N = 6): an Fp12 product (Karatsuba over Fp6 over Fp2) is 18 Fp2
// products, three a thread; a cyclotomic square (Granger and Scott 2010)
// six Fp2 products, one a thread. B4 runs half-warps (N = 16) or sextets
// over batches: a batch queues the independent Fp2 products of one stage of
// a Miller step (the Fp12 square beside the line's and the doubling's
// products, or the product by the sparse line) and deals their Fp products
// out N ways.
// The threads run the same instructions on different operands: a warp
// issues one stream for all its groups, so a lane's chain of products is
// as long as one thread's share.
//
// A group type G has N (1, 3, 6 or 16), t (this thread's index) and, for N > 1,
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
// N lanes of a warp (a trio, N = 3; a sextet, N = 6; a half-warp, N =
// 16); slot words of shared memory a lane, two sets
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

// up to three independent Fp products o_j = a_j b_j (j < n) on a trio:
// thread j computes product j and every thread takes all n (G1's Jacobian
// steps, whose products come in rounds of at most three). Outputs past n
// are left alone; the operands of an unused product are read, not used. An
// output may alias an operand.
template <class G>
__device__ BLS_NOINLINE void fp_round(fp& o0, fp& o1, fp& o2, const fp& a0, const fp& b0,
                                      const fp& a1, const fp& b1, const fp& a2, const fp& b2,
                                      int n, G& g) {
  static_assert(G::N == 3, "a round of Fp products splits over three lanes");
  fp x, y, p;
  fp_sel(x, g.t == 0, a0, g.t == 1 ? a1 : a2);
  fp_sel(y, g.t == 0, b0, g.t == 1 ? b1 : b2);
  fp_mul(p, x, y);
  tr_put(g, p.v, NW);
  from_words(o0, g.at(0));
  if (n > 1) from_words(o1, g.at(1));
  if (n > 2) from_words(o2, g.at(2));
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

// ---------------------------------------------------- batches of products
// A batch queues up to MJ jobs, each an Fp2 product, an Fp2 square or an
// Fp2-by-Fp product, that are independent: no job reads another's output,
// and no output is read before run(). Solo, each job runs as it is queued.
// On a group of N threads the jobs' Fp products (three an Fp2 product, two
// a square or an Fp2-by-Fp product) form one list, alike on every thread;
// thread t computes products t, t + N, t + 2N, ..., each (x0 + x1)(y0 + y1)
// with x1, y1 zero where the product needs no sum, publishes them, and
// after the group's sync every thread assembles every job's output (a
// second exchange of the outputs, each thread assembling a share, measured
// slower on the card). The operands are read at run(): they must live,
// unchanged, until then.

enum { JOB_MUL = 0, JOB_SQ = 1, JOB_MUL_FP = 2 };

template <class G, int MJ>
struct batch {
  static constexpr int MP = 3 * MJ;                  // Fp products at most
  static constexpr int MK = (MP + G::N - 1) / G::N;  // one thread's share at most
  static constexpr int SLOT = MK * NW;               // exchange words a thread
  int t, nj = 0, np = 0;
  fp2* out[MJ];
  int kind[MJ];
  const fp* x0[MK];  // this thread's products (x0 + x1)(y0 + y1)
  const fp* x1[MK];
  const fp* y0[MK];
  const fp* y1[MK];
  fp neg[MK];  // -b of a square's (a + b)(a - b)
  fp zero;

  __device__ explicit batch(const G& g) : t(g.t) { fp_zero(zero); }

  __device__ __forceinline__ void prod(const fp* a0, const fp* a1, const fp* b0, const fp* b1,
                                       bool neg_b1) {
    if (np % G::N == t) {
      const int k = np / G::N;
      x0[k] = a0;
      x1[k] = a1 ? a1 : &zero;
      y0[k] = b0;
      if (neg_b1) {
        fp_neg(neg[k], *b1);
        y1[k] = &neg[k];
      } else {
        y1[k] = b1 ? b1 : &zero;
      }
    }
    ++np;
  }

  // o = x y: x.a y.a, x.b y.b, (x.a + x.b)(y.a + y.b)
  __device__ __forceinline__ void mul(fp2& o, const fp2& x, const fp2& y) {
    out[nj] = &o;
    kind[nj++] = JOB_MUL;
    prod(&x.a, nullptr, &y.a, nullptr, false);
    prod(&x.b, nullptr, &y.b, nullptr, false);
    prod(&x.a, &x.b, &y.a, &y.b, false);
  }

  // o = x^2: (a + b)(a - b), a b
  __device__ __forceinline__ void sq(fp2& o, const fp2& x) {
    out[nj] = &o;
    kind[nj++] = JOB_SQ;
    prod(&x.a, &x.b, &x.a, &x.b, true);
    prod(&x.a, nullptr, &x.b, nullptr, false);
  }

  // o = x k for k in Fp
  __device__ __forceinline__ void mul_fp(fp2& o, const fp2& x, const fp& k) {
    out[nj] = &o;
    kind[nj++] = JOB_MUL_FP;
    prod(&x.a, nullptr, &k, nullptr, false);
    prod(&x.b, nullptr, &k, nullptr, false);
  }

  __device__ BLS_NOINLINE void run(G& g) {
    fp mine[MK];
    const int nk = (np + G::N - 1) / G::N;
    for (int k = 0; k < nk; ++k) {
      if (k * G::N + t < np) {
        fp a, b;
        fp_add(a, *x0[k], *x1[k]);
        fp_add(b, *y0[k], *y1[k]);
        fp_mul(mine[k], a, b);
      }
    }
    tr_put(g, mine[0].v, nk * NW);
    for (int j = 0, i = 0; j < nj; ++j) {
      const int parts = kind[j] == JOB_MUL ? 3 : 2;
      const fp* p[3];
      for (int q = 0; q < parts; ++q, ++i)
        p[q] = reinterpret_cast<const fp*>(g.at(i % G::N) + (i / G::N) * NW);
      fp2& o = *out[j];
      if (kind[j] == JOB_MUL) {
        fp s;
        fp_add(s, *p[0], *p[1]);
        fp_sub(o.a, *p[0], *p[1]);
        fp_sub(o.b, *p[2], s);
      } else if (kind[j] == JOB_SQ) {
        o.a = *p[0];
        fp_dbl(o.b, *p[1]);
      } else {
        o.a = *p[0];
        o.b = *p[1];
      }
    }
    nj = np = 0;
  }
};

template <int MJ>
struct batch<solo, MJ> {
  static constexpr int SLOT = 0;
  __device__ explicit batch(const solo&) {}
  __device__ __forceinline__ void mul(fp2& o, const fp2& x, const fp2& y) { f2_mul(o, x, y); }
  __device__ __forceinline__ void sq(fp2& o, const fp2& x) { f2_sq(o, x); }
  __device__ __forceinline__ void mul_fp(fp2& o, const fp2& x, const fp& k) { f2_mul_fp(o, x, k); }
  __device__ __forceinline__ void run(solo&) {}
};

// An Fp6 product x y as six Fp2 products on a batch (Karatsuba, f6_mul's
// terms): queue(), the batch's run(), then finish(). x and y must live
// until the run.
struct f6_job {
  fp2 s[6], r[6];

  template <class B>
  __device__ __forceinline__ void queue(B& b, const fp6& x, const fp6& y) {
    f2_add(s[0], x.c1, x.c2);
    f2_add(s[1], y.c1, y.c2);
    f2_add(s[2], x.c0, x.c1);
    f2_add(s[3], y.c0, y.c1);
    f2_add(s[4], x.c0, x.c2);
    f2_add(s[5], y.c0, y.c2);
    b.mul(r[0], x.c0, y.c0);
    b.mul(r[1], x.c1, y.c1);
    b.mul(r[2], x.c2, y.c2);
    b.mul(r[3], s[0], s[1]);
    b.mul(r[4], s[2], s[3]);
    b.mul(r[5], s[4], s[5]);
  }

  // (t0 + xi (m12 - t1 - t2), m01 - t0 - t1 + xi t2, m02 - t0 - t2 + t1)
  __device__ __forceinline__ void finish(fp6& o) const {
    fp2 u;
    f2_add(u, r[1], r[2]);
    f2_sub(o.c0, r[3], u);
    f2_mul_xi(o.c0, o.c0);
    f2_add(o.c0, o.c0, r[0]);
    f2_add(u, r[0], r[1]);
    f2_sub(o.c1, r[4], u);
    f2_mul_xi(u, r[2]);
    f2_add(o.c1, o.c1, u);
    f2_add(u, r[0], r[2]);
    f2_sub(o.c2, r[5], u);
    f2_add(o.c2, o.c2, r[1]);
  }
};

// a^2 in Fp12 by the complex method: with A = a0 a1 and B = (a0 + a1)(a0 +
// v a1), a^2 = (B - A - v A) + 2 A w; two Fp6 products, 12 Fp2 products (36
// Fp products, not f12_mul(a, a)'s 54). a must live until the run; the
// output may alias it.
struct f12_sq_job {
  fp6 s, u;
  f6_job m0, m1;

  template <class B>
  __device__ __forceinline__ void queue(B& b, const fp12& a) {
    f6_add(s, a.d0, a.d1);
    f6_mul_v(u, a.d1);
    f6_add(u, u, a.d0);
    m0.queue(b, a.d0, a.d1);
    m1.queue(b, s, u);
  }

  __device__ __forceinline__ void finish(fp12& o) {
    fp6 x, y;
    m0.finish(x);
    m1.finish(y);
    f6_sub(y, y, x);
    f6_mul_v(u, x);
    f6_sub(o.d0, y, u);
    f6_add(o.d1, x, x);
  }
};

// f l for the sparse line l = c0 + (b1 v + b2 v^2) w, with L0 = c0 and L1 =
// (0, b1, b2): f0 L0 (three Fp2 products), f1 L1 (five: a1 b1, a2 b2,
// (a1 + a2)(b1 + b2), a0 b1, a0 b2) and (f0 + f1)(c0, b1, b2) (six), then
// (f0 L0 + v f1 L1, (f0 + f1)(L0 + L1) - f0 L0 - f1 L1): 14 Fp2 products
// (42 Fp products, not f12_mul's 54). f must live until the run; the output
// may alias it.
struct f12_line_job {
  fp6 s, l;
  fp2 t0[3], a11, a22, m, a01, a02, s12, b12;
  f6_job cross;

  template <class B>
  __device__ __forceinline__ void queue(B& b, const fp12& f, const fp2& c0, const fp2& b1,
                                        const fp2& b2) {
    l.c0 = c0;
    l.c1 = b1;
    l.c2 = b2;
    b.mul(t0[0], f.d0.c0, l.c0);
    b.mul(t0[1], f.d0.c1, l.c0);
    b.mul(t0[2], f.d0.c2, l.c0);
    f2_add(s12, f.d1.c1, f.d1.c2);
    f2_add(b12, l.c1, l.c2);
    b.mul(a11, f.d1.c1, l.c1);
    b.mul(a22, f.d1.c2, l.c2);
    b.mul(m, s12, b12);
    b.mul(a01, f.d1.c0, l.c1);
    b.mul(a02, f.d1.c0, l.c2);
    f6_add(s, f.d0, f.d1);
    cross.queue(b, s, l);
  }

  __device__ __forceinline__ void finish(fp12& o) {
    fp6 x, y, c;
    x.c0 = t0[0];
    x.c1 = t0[1];
    x.c2 = t0[2];
    // f1 L1 = (xi (m - a11 - a22), a01 + xi a22, a02 + a11)
    fp2 u;
    f2_add(u, a11, a22);
    f2_sub(y.c0, m, u);
    f2_mul_xi(y.c0, y.c0);
    f2_mul_xi(u, a22);
    f2_add(y.c1, a01, u);
    f2_add(y.c2, a02, a11);
    cross.finish(c);
    f6_sub(c, c, x);
    f6_sub(o.d1, c, y);
    f6_mul_v(y, y);
    f6_add(o.d0, x, y);
  }
};

// the jobs of the Miller loop's batches at most (a doubling step's first:
// the Fp12 square's 12 beside the tangent's and the doubling's 7)
constexpr int MILLER_JOBS = 20;

// o = a^2 in Fp12 (f12_sq_job on one batch); o may alias a
template <class G>
__device__ BLS_NOINLINE void g12_sq(fp12& o, const fp12& a, G& g) {
  batch<G, MILLER_JOBS> b(g);
  f12_sq_job q;
  q.queue(b, a);
  b.run(g);
  q.finish(o);
}

// o = f (c0 + (b1 v + b2 v^2) w) (f12_line_job on one batch); o may alias f
template <class G>
__device__ BLS_NOINLINE void g12_mul_line(fp12& o, const fp12& f, const fp2& c0, const fp2& b1,
                                          const fp2& b2, G& g) {
  batch<G, MILLER_JOBS> b(g);
  f12_line_job q;
  q.queue(b, f, c0, b1, b2);
  b.run(g);
  q.finish(o);
}

}  // namespace bls
