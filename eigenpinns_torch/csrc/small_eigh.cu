// Symmetric eigensolver for one small dense matrix (n <= 84, fp32 or
// fp64) in one thread block: parallel two-sided cyclic Jacobi.
//
// Replaces no TPU kernel. It takes the place of torch.linalg.eigh in the
// LOBPCG polish (solvers/rayleigh_ritz.py::eigh): the fp64 Rayleigh-Ritz
// solve at n = 84 and the two fp32 whitenings at n = 28 of every
// iteration. The library's CUDA eigh tridiagonalises through a chain of
// ~2n small launches (ormtr_gemv / ormtr_gerc at n = 84) and then checks
// its info word on the host, so each call leaves the card idle while the
// host waits. This kernel is one launch that never synchronises: a
// failure (a nonfinite input, or no convergence within max_sweeps) fills
// the outputs with NaN and writes 1 to a status word on the device, which
// the caller reads when it next reads the card anyway.
//
// What bounds it. An 84 x 84 eigensolve is a few MFLOP, ~10 us of one
// SM's fp64 rate; the card's other SMs idle, so the time is one SM's. A
// Jacobi sweep visits every pair (p, q) once, in rounds of disjoint pairs
// that rotate together; a round rewrites all of A (two-sided) and V (one
// side), ~n^2 / 2 2x2 block updates of A in shared memory and n^2 / 2
// column-pair updates of V, and the polish's matrices converge in 7
// sweeps of n rounds. So the time is rounds x (the longer of two paths a
// round): warp 0's chain of dependent operations from one round's
// rotations to the next's, and the other warps' shared-memory traffic
// and fp64 FMAs. On an H100 (700 W) the fp64 solve at n = 84 takes 588
// rounds of ~2,300 cycles (0.76 ms), the fp32 one at n = 28 196 of ~480
// (0.06 ms). The design:
//
//  * Ordering. Positions 0..m-1 (m = S * P, n padded to it with zero
//    rows and columns, which never rotate: their couplings stay exactly
//    0) pair as (2k, 2k+1) in even rounds and (2k+1, 2k+2) in odd ones,
//    and the two elements of every pair swap positions after it rotates
//    (the odd-even ordering: each pair of elements meets once in m
//    rounds). The element at a position follows in closed form
//    (elem_at): it bounces between the ends, one step a round.
//  * V in registers. A thread holds S adjacent positions of one row of
//    V, P threads (adjacent lanes) a row. A rotation with the swap is
//    two FMAs into the registers of the pair, so positions stay static
//    registers; an odd round's pairs that straddle two threads exchange
//    one value by a shuffle. No V traffic in shared memory.
//  * A in shared memory, by element: one copy of each (i, j), i <= j
//    (canonical), storage index iota(e) chosen so that the pairs of
//    adjacent lanes touch adjacent rows and columns (no bank conflicts).
//    Each 2x2 block of a round (rows of pair P1, columns of pair P2) is
//    read and written in place by one thread.
//  * Warp 0 computes the next round's rotations while the round runs. It
//    owns the blocks that hold the next round's pairs: the diagonal
//    blocks (exact Jacobi update) and the blocks of cyclically adjacent
//    pairs. It carries the rotations in registers and gets its
//    neighbours' values by shuffles, so its chain holds one
//    shared-memory load a round; the rotation itself is branch-free
//    (make_rot). The other warps own every other block of A and V, in a
//    loop of their own (so that neither loop's registers are live in the
//    other's); the two meet at one barrier a round.
//
// A pair rotates when |a_pq| > tol = eps * ||A||_F; the solve stops after
// the sweep that leaves every off-diagonal entry at most tol (a scan of A
// at each sweep's end). Arithmetic is in the input's type throughout (no
// tensor cores). It takes n <= 84, where a thread holds at most 16
// positions of V: with 32 (n = 128) the fp64 registers spill and the
// solve is slower than the library's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 84;              // the largest n and m = S * P
constexpr int kMaxPairs = kMaxN / 2;
constexpr int kMaxThreads = 576;       // the launch bound
constexpr int kMaxBlocks = 2;          // bulk blocks a thread
constexpr int kS[] = {4, 6, 8, 10, 12, 14, 16};   // the instantiations
constexpr int kMaxDevices = 64;

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ float eps() { return 1.1920928955078125e-07f; }
  static __device__ float nan() { return __int_as_float(0x7fc00000); }
};
template <> struct Num<double> {
  static __device__ double eps() { return 2.220446049250313e-16; }
  static __device__ double nan() {
    return __longlong_as_double(0x7ff8000000000000ll);
  }
};

// The element (its index in the input) at position pos after r rounds of
// the odd-even ordering on m positions, r in [0, 2m). In round r the
// element at pos moves right when pos + r is even; unfolded onto a cycle
// of 2m steps (u < m: position u moving right, u >= m: position 2m-1-u
// moving left) every element advances one step a round.
__device__ __forceinline__ int elem_at(int pos, int r, int m) {
  int u = ((pos + r) & 1) ? 2 * m - 1 - pos : pos;
  int u0 = u - r;
  if (u0 < 0) u0 += 2 * m;
  return u0 < m ? u0 : 2 * m - 1 - u0;
}

// Storage index of element e: even elements first. The pairs of adjacent
// lanes hold elements two apart, so their storage indices are adjacent.
__device__ __forceinline__ int iota(int e, int h) {
  return (e & 1) ? h + (e >> 1) : (e >> 1);
}

__device__ __forceinline__ int canon(int i, int j, int ld) {
  return i < j ? i * ld + j : j * ld + i;
}

// Positions (a, b) of pair k: even rounds (2k, 2k+1); odd rounds (2k+1,
// 2k+2) for k < h-1 and, for k = h-1, the two ends (m-1, 0), which stay
// put and do not rotate (the pseudo pair).
__device__ __forceinline__ void pair_pos(int k, int odd, int m, int h,
                                         int& a, int& b) {
  if (!odd) {
    a = 2 * k;
    b = 2 * k + 1;
  } else if (k < h - 1) {
    a = 2 * k + 1;
    b = 2 * k + 2;
  } else {
    a = m - 1;
    b = 0;
  }
}

// 1 / sqrt(x) without branches: the hardware's estimate refined by
// Newton steps in the type's own arithmetic (one in fp32; two in fp64,
// from the ~2^-22 of rsqrt.approx.f64): within an ulp or two. The
// arguments here are positive and normal (see make_rot).
__device__ __forceinline__ float rsqrt_nr(float x) {
  float y = rsqrtf(x);
  return y * fmaf(-0.5f * x * y, y, 1.5f);
}
__device__ __forceinline__ double rsqrt_nr(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  y = y * fma(-0.5 * x * y, y, 1.5);
  return y * fma(-0.5 * x * y, y, 1.5);
}

// The Jacobi rotation that zeroes a_pq (Golub & Van Loan's sym.schur2):
// with d = a_qq - a_pp, g = 2 a_pq, r = hypot(d, g) and u = |d| + r,
// t = tan(phi) = sign(d) g / u, c = 1 / sqrt(1 + t^2) = u / sqrt(2 r u),
// s = t c = sign(d) g / sqrt(2 r u), and 1 / u = 2 r / (2 r u), so one
// reciprocal square root of 2 r u gives all three; identity when
// |a_pq| <= tol. With max |a| < 1 and |a_pq| > tol >= eps / 2, d^2 + g^2
// and 2 r u lie in (eps^2, 32]: no overflow, nothing subnormal.
template <typename T>
__device__ __forceinline__ void make_rot(T app, T aqq, T apq, T tol, T& c,
                                         T& s, T& t) {
  T d = aqq - app, g = T(2) * apq;
  T r2 = d * d + g * g;
  T r = r2 * rsqrt_nr(r2);
  T u = fabs(d) + r;
  T iq = rsqrt_nr(T(2) * r * u);
  T sg = d < T(0) ? -g : g;
  c = u * iq;
  s = sg * iq;
  t = s * (T(2) * r * iq);
  if (!(fabs(apq) > tol)) {
    c = T(1);
    s = T(0);
    t = T(0);
  }
}

// A pair's rotation J = [c s; -s c] on its elements (p, q): a 2x2 block
// X of A with the rows of pair P1 and the columns of pair P2 becomes
// J1^T X J2; V's columns of the pair become V J.
template <typename T>
struct Rot {
  T c, s;
};

template <typename T>
struct Shared {
  Rot<T> rot[2][kMaxPairs];   // (c, s) of each pair, by round parity
  int2 idx[2][kMaxPairs];     // storage indices of each pair's elements
  T lam[kMaxN];               // eigenvalues by element
  T red[32];
  int rank[kMaxN];
  int bad;
};

template <typename T, bool kMax>
__device__ __forceinline__ T block_reduce(T x, T* red) {
  for (int o = 16; o; o >>= 1) {
    T y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmax(x, y) : x + y;
  }
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  T total = T(0);
  for (int i = 0; i < int(blockDim.x >> 5); ++i)
    total = kMax ? fmax(total, red[i]) : total + red[i];
  return total;
}

// The value x of pair q (< 64) held by warp 0: pair q is lane q % 32's
// slot q / 32 (x[0] or x[1]). Every lane calls it.
template <int kSlots, typename T>
__device__ __forceinline__ T of_pair(const T (&x)[2], int q) {
  T a = __shfl_sync(0xffffffffu, x[0], q & 31);
  if (kSlots == 1) return a;
  T b = __shfl_sync(0xffffffffu, x[1], q & 31);
  return q < 32 ? a : b;
}

// Storage indices of pair k's elements in round r (parity odd, r % 2m =
// rmod).
__device__ __forceinline__ int2 pair_idx(int k, int odd, int rmod, int m,
                                         int h) {
  int a, b;
  pair_pos(k, odd, m, h, a, b);
  return make_int2(iota(elem_at(a, rmod, m), h), iota(elem_at(b, rmod, m), h));
}

// The block's barriers: warp 0 and the other warps run separate loops
// (so that neither's registers are live in the other's), which meet at
// named barrier 1 each round; barrier 2 ORs a flag over the block.
__device__ __forceinline__ void bar_all(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}
__device__ __forceinline__ int bar_or(int x, int nthreads) {
  int out;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\tsetp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, 2, %2, p;\n\tselp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(out)
      : "r"(x), "r"(nthreads)
      : "memory");
  return out;
}

// One round ends for every thread: the round counters advance (r % 2m in
// rmod, r % m in rs); at the end of a sweep the block checks whether
// every off-diagonal entry is at most tol (then the next sweep would
// rotate no pair: converged), or the sweep cap is reached (failed).
// Returns whether the solve stops.
template <typename T>
__device__ __forceinline__ bool end_round(const T* A, int m, T tol,
                                          int max_sweeps, int nthreads,
                                          int& rmod, int& rs, int& sweep,
                                          int& failed) {
  rmod = rmod + 1 == 2 * m ? 0 : rmod + 1;
  if (++rs < m) return false;
  rs = 0;
  int above = 0;
  for (int x = threadIdx.x; x < m * m; x += nthreads) {
    int si = x / m, sj = x - si * m;
    above |= si < sj && fabs(A[x]) > tol;
  }
  if (!bar_or(above, nthreads)) return true;
  if (++sweep >= max_sweeps) {
    failed = 1;
    return true;
  }
  return false;
}

// Warp 0's loop: it carries the rotations from round to round in
// registers. Lane l holds pairs k = l + 32 j (slots j = 0, 1; slot 1 only
// when there are more than 32 pairs): the pair's rotation in the current
// round (c, s, t), the values of its 2x2 diagonal block before the round
// (app, aqq, apq), its elements' storage indices, and the rotation and
// indices of pair k + 1 (cyclic), whose block with pair k (the adjacent
// block) it updates too. Each round it updates those blocks, derives the
// next round's pairs' diagonal blocks from the values it just computed
// and computes their rotations, which the other warps read after the
// round's barrier.
template <typename T, int kSlots>
__device__ void rotation_loop(T* A, Shared<T>& sh, int m, int h, T tol,
                              int max_sweeps, int nthreads, int& rmod,
                              int& failed) {
  const int lane = threadIdx.x & 31;
  T c[2], s[2], t[2], app[2], aqq[2], apq[2], nc[2], ns[2];
  int ix0[2], ix1[2], nix0[2], nix1[2];
  // Publish the round's rotations (parity odd) for the other warps and
  // fetch each slot's neighbour pair's.
  auto publish = [&](int odd) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      int k = lane + 32 * j;
      if (k < h) {
        sh.rot[odd][k] = Rot<T>{c[j], s[j]};
        sh.idx[odd][k] = make_int2(ix0[j], ix1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      int k = lane + 32 * j, q = k + 1 >= h ? 0 : k + 1;
      nc[j] = of_pair<kSlots>(c, q);
      ns[j] = of_pair<kSlots>(s, q);
      nix0[j] = of_pair<kSlots>(ix0, q);
      nix1[j] = of_pair<kSlots>(ix1, q);
    }
  };
  // The rotations of round 0.
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    int k = min(lane + 32 * j, h - 1);
    int2 ij = pair_idx(k, 0, 0, m, h);
    ix0[j] = ij.x;
    ix1[j] = ij.y;
    app[j] = A[ij.x * m + ij.x];
    aqq[j] = A[ij.y * m + ij.y];
    apq[j] = A[canon(ij.x, ij.y, m)];
    make_rot(app[j], aqq[j], apq[j], tol, c[j], s[j], t[j]);
  }
  publish(0);
  bar_all(nthreads);
  int r = 0, rs = 0, sweep = 0;
  for (;;) {
    const int odd = r & 1;
    const int rnmod = rmod + 1 == 2 * m ? 0 : rmod + 1;
    T x[2][4];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int2 i1 = make_int2(ix0[j], ix1[j]);
      const int2 i2 = make_int2(nix0[j], nix1[j]);
      x[j][0] = A[canon(i1.x, i2.x, m)];
      x[j][1] = A[canon(i1.x, i2.y, m)];
      x[j][2] = A[canon(i1.y, i2.x, m)];
      x[j][3] = A[canon(i1.y, i2.y, m)];
    }
    T Dl[2], Dr[2], y00[2], y01[2], y11[2];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      int k = min(lane + 32 * j, h - 1);
      const int2 i1 = make_int2(ix0[j], ix1[j]);
      const int2 i2 = make_int2(nix0[j], nix1[j]);
      T c1 = c[j], s1 = s[j], c2 = nc[j], s2 = ns[j];
      T z00 = c2 * x[j][0] - s2 * x[j][1], z01 = s2 * x[j][0] + c2 * x[j][1];
      T z10 = c2 * x[j][2] - s2 * x[j][3], z11 = s2 * x[j][2] + c2 * x[j][3];
      y00[j] = c1 * z00 - s1 * z10;
      y01[j] = c1 * z01 - s1 * z11;
      T y10 = s1 * z00 + c1 * z10;
      y11[j] = s1 * z01 + c1 * z11;
      Dl[j] = app[j] - t[j] * apq[j];
      Dr[j] = aqq[j] + t[j] * apq[j];
      // The adjacent block (k, k + 1) and the diagonal block of pair k.
      if (lane + 32 * j < h && !(h == 2 && k == 1)
          && (s1 != T(0) || s2 != T(0))) {
        A[canon(i1.x, i2.x, m)] = y00[j];
        A[canon(i1.x, i2.y, m)] = y01[j];
        A[canon(i1.y, i2.x, m)] = y10;
        A[canon(i1.y, i2.y, m)] = y11[j];
      }
      if (lane + 32 * j < h && s1 != T(0)) {
        A[i1.x * m + i1.x] = Dl[j];
        A[i1.y * m + i1.y] = Dr[j];
        A[canon(i1.x, i1.y, m)] = T(0);
      }
    }
    // The next round's pairs: after an even round pair k joins an
    // element of pair k with one of pair k + 1, after an odd one of pair
    // k - 1 and pair k; the pseudo pair (m-1, 0) of an odd round does not
    // rotate.
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      int k = min(lane + 32 * j, h - 1);
      if (!odd) {
        int q = k + 1 >= h ? 0 : k + 1;
        app[j] = Dl[j];
        aqq[j] = of_pair<kSlots>(Dr, q);
        apq[j] = y01[j];
      } else {
        int q = k == 0 ? h - 1 : k - 1;
        T dl = of_pair<kSlots>(Dl, q), dr = of_pair<kSlots>(Dr, q);
        T b00 = of_pair<kSlots>(y00, q), b01 = of_pair<kSlots>(y01, q);
        T b11 = of_pair<kSlots>(y11, q);
        app[j] = k == 0 ? dr : dl;
        aqq[j] = k == h - 1 ? Dl[j] : Dr[j];
        apq[j] = k == 0 ? b11 : k == h - 1 ? b00 : b01;
      }
      int2 ij = pair_idx(k, odd ^ 1, rnmod, m, h);
      ix0[j] = ij.x;
      ix1[j] = ij.y;
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      int k = min(lane + 32 * j, h - 1);
      make_rot(app[j], aqq[j], apq[j],
               !odd && k == h - 1 ? T(INFINITY) : tol, c[j], s[j], t[j]);
    }
    publish(odd ^ 1);
    bar_all(nthreads);
    ++r;
    if (end_round(A, m, tol, max_sweeps, nthreads, rmod, rs, sweep, failed))
      break;
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
small_eigh_kernel(const T* __restrict__ a, T* __restrict__ w,
                  T* __restrict__ v, int* __restrict__ status, int n, int P,
                  int max_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared<T>& sh = *reinterpret_cast<Shared<T>*>(smem);
  T* A = reinterpret_cast<T*>(smem + ((sizeof(Shared<T>) + 15) & ~15));
  const int m = S * P, h = m / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;

  // Load the lower triangle into the canonical storage (zero padding), and
  // find max |a| and whether every entry is finite.
  T amax = T(0);
  int bad = 0;
  for (int x = tid; x < m * m; x += nthreads) {
    int si = x / m, sj = x - si * m;
    if (si > sj) continue;
    int ei = si < h ? 2 * si : 2 * (si - h) + 1;
    int ej = sj < h ? 2 * sj : 2 * (sj - h) + 1;
    T val = T(0);
    if (ei < n && ej < n)
      val = ei >= ej ? a[ei * n + ej] : a[ej * n + ei];
    if (!isfinite(val)) bad = 1;
    amax = fmax(amax, fabs(val));
    A[x] = val;
  }
  if (tid == 0) sh.bad = 0;
  __syncthreads();
  if (bad) sh.bad = 1;
  amax = block_reduce<T, true>(amax, sh.red);   // orders sh.bad too
  int failed = sh.bad;
  // Scale by a power of two to max |a| in [0.5, 1) (exact), so that no
  // square overflows; the eigenvalues are scaled back.
  int expo = 0;
  if (!failed && amax > T(0)) frexp(amax, &expo);
  const T scale = ldexp(T(1), -expo);
  T sq = T(0);
  for (int x = tid; x < m * m; x += nthreads) {
    int si = x / m, sj = x - si * m;
    if (si > sj) continue;
    T y = A[x] * scale;
    A[x] = y;
    sq += (si == sj ? T(1) : T(2)) * y * y;
  }
  sq = block_reduce<T, false>(sq, sh.red);
  const T tol = Num<T>::eps() * sqrt(sq);

  int rmod = 0;   // rounds run, mod 2m
  if (warp == 0) {
    if (!failed && h > 32)
      rotation_loop<T, 2>(A, sh, m, h, tol, max_sweeps, nthreads, rmod,
                          failed);
    else if (!failed)
      rotation_loop<T, 1>(A, sh, m, h, tol, max_sweeps, nthreads, rmod,
                          failed);
    if (!failed) {
      // Eigenvalues by element (scaled back) and their ascending ranks
      // (ties by element).
      for (int e = lane; e < n; e += 32) {
        int s = iota(e, h);
        sh.lam[e] = ldexp(A[s * m + s], expo);
      }
      __syncwarp();
      for (int e = lane; e < n; e += 32) {
        T le = sh.lam[e];
        int rk = 0;
        for (int i = 0; i < n; ++i) {
          T li = sh.lam[i];
          rk += (li < le) || (li == le && i < e);
        }
        sh.rank[e] = rk;
        w[rk] = le;
      }
    }
    bar_all(nthreads);
  } else {
    // V: thread (row, part) holds positions [part*S, part*S+S) of row
    // `row`; lanes past the last whole row idle along.
    const int rows_per_warp = 32 / P;
    const int part = lane % P;
    const int row = (warp - 1) * rows_per_warp + lane / P;
    T vr[S];
#pragma unroll
    for (int l = 0; l < S; ++l) vr[l] = (part * S + l == row) ? T(1) : T(0);
    if (!failed) {
      const Rot<T>* my_rot0 = &sh.rot[0][part * (S / 2)];
      const Rot<T>* my_rot1 = &sh.rot[1][part * (S / 2)];
      // Bulk blocks: pair P1 = bt % h with P2 = P1 + d (cyclic), d from 2
      // to h / 2 (only P1 < h/2 at d = h/2 when h is even), d = 2 + g,
      // 2 + g + G, ... for the thread's group g = bt / h of G = (bulk
      // threads) / h; at most kMaxBlocks a thread (`grid_for`).
      const int bt = tid - 32;
      const int groups = (nthreads - 32) / h;
      const int bp = bt % h, bg = bt / h;
      const int dmax = h / 2;
      bar_all(nthreads);
      int r = 0, rs = 0, sweep = 0;
      for (;;) {
        const int odd = r & 1;
        // The other blocks of A: loads first, then V's rotations while
        // they arrive, then the blocks' products and stores.
        const Rot<T> r1 = sh.rot[odd][bp];
        const int2 i1 = sh.idx[odd][bp];
        T x[kMaxBlocks][4], c2[kMaxBlocks], s2[kMaxBlocks];
        int2 i2[kMaxBlocks];
        bool on[kMaxBlocks];
#pragma unroll
        for (int b = 0; b < kMaxBlocks; ++b) {
          int d = 2 + bg + b * groups;
          on[b] = bg < groups && d <= dmax && !(2 * d == h && bp >= dmax);
          int p2 = bp + d;
          if (p2 >= h) p2 -= h;
          if (on[b]) {
            const Rot<T> q = sh.rot[odd][p2];
            c2[b] = q.c;
            s2[b] = q.s;
            i2[b] = sh.idx[odd][p2];
            x[b][0] = A[canon(i1.x, i2[b].x, m)];
            x[b][1] = A[canon(i1.x, i2[b].y, m)];
            x[b][2] = A[canon(i1.y, i2[b].x, m)];
            x[b][3] = A[canon(i1.y, i2[b].y, m)];
          }
        }
        // V: rotate the round's pairs and swap their positions.
        if (!odd) {
#pragma unroll
          for (int i = 0; i < S / 2; ++i) {
            const Rot<T> q = my_rot0[i];
            T x0 = vr[2 * i], y0 = vr[2 * i + 1];
            vr[2 * i] = q.s * x0 + q.c * y0;
            vr[2 * i + 1] = q.c * x0 - q.s * y0;
          }
        } else {
          T from_left = __shfl_up_sync(0xffffffffu, vr[S - 1], 1);
          T from_right = __shfl_down_sync(0xffffffffu, vr[0], 1);
#pragma unroll
          for (int i = 0; i < S / 2 - 1; ++i) {
            const Rot<T> q = my_rot1[i];
            T x0 = vr[2 * i + 1], y0 = vr[2 * i + 2];
            vr[2 * i + 1] = q.s * x0 + q.c * y0;
            vr[2 * i + 2] = q.c * x0 - q.s * y0;
          }
          if (part > 0) {
            const Rot<T> q = my_rot1[-1];
            vr[0] = q.c * from_left - q.s * vr[0];
          }
          if (part < P - 1) {
            const Rot<T> q = my_rot1[S / 2 - 1];
            vr[S - 1] = q.s * vr[S - 1] + q.c * from_right;
          }
        }
#pragma unroll
        for (int b = 0; b < kMaxBlocks; ++b) {
          if (!on[b] || (r1.s == T(0) && s2[b] == T(0))) continue;
          T cc = c2[b], ss = s2[b];
          T z00 = cc * x[b][0] - ss * x[b][1];
          T z01 = ss * x[b][0] + cc * x[b][1];
          T z10 = cc * x[b][2] - ss * x[b][3];
          T z11 = ss * x[b][2] + cc * x[b][3];
          A[canon(i1.x, i2[b].x, m)] = r1.c * z00 - r1.s * z10;
          A[canon(i1.y, i2[b].x, m)] = r1.s * z00 + r1.c * z10;
          A[canon(i1.x, i2[b].y, m)] = r1.c * z01 - r1.s * z11;
          A[canon(i1.y, i2[b].y, m)] = r1.s * z01 + r1.c * z11;
        }
        bar_all(nthreads);
        ++r;
        if (end_round(A, m, tol, max_sweeps, nthreads, rmod, rs, sweep,
                      failed))
          break;
      }
    }
    bar_all(nthreads);   // the ranks
    if (!failed && lane / P < rows_per_warp && row < n) {
#pragma unroll
      for (int l = 0; l < S; ++l) {
        int e = elem_at(part * S + l, rmod, m);
        if (e < n) v[row * n + sh.rank[e]] = vr[l];
      }
    }
  }
  if (failed) {
    for (int x = tid; x < n * n; x += nthreads) v[x] = Num<T>::nan();
    for (int x = tid; x < n; x += nthreads) w[x] = Num<T>::nan();
    if (tid == 0) *status = 1;
  }
}

// Warps of the block past warp 0 for n x n on the grid (S, P): enough
// for V's rows (32 / P rows a warp) and for the bulk blocks of A (h
// threads a group, kMaxBlocks of the h / 2 - 1 distances a group).
int bulk_warps(int n, int S, int P) {
  const int h = S * P / 2, rows_per_warp = 32 / P;
  const int dists = h / 2 - 1 > 0 ? h / 2 - 1 : 0;
  int w = (n + rows_per_warp - 1) / rows_per_warp;
  const int w_pairs = (h + 31) / 32;
  const int groups = (dists + kMaxBlocks - 1) / kMaxBlocks;
  const int w_blocks = (groups * h + 31) / 32;
  w = w_pairs > w ? w_pairs : w;
  return w_blocks > w ? w_blocks : w;
}

struct Grid {
  int S, P, threads;
};

// The grid for n x n (1 <= n <= kMaxN): P threads (adjacent lanes) hold a
// row of V, S positions each, on m = S * P >= n positions (n padded with
// rows and columns that never rotate). The smallest m, then the most
// threads a row (a round's work spread widest), within the launch bound.
Grid grid_for(int n) {
  Grid best = {0, 0, 0};
  for (int S : kS) {
    const int P = (n + S - 1) / S;
    if (P > 32) continue;
    const int threads = 32 * (1 + bulk_warps(n, S, P));
    if (threads > kMaxThreads) continue;
    const int m = S * P, best_m = best.S * best.P;
    if (best.S == 0 || m < best_m || (m == best_m && P > best.P))
      best = {S, P, threads};
  }
  return best;
}

template <typename T, int S>
cudaError_t launch(const void* a, void* w, void* v, int* status, int n,
                   const Grid& g, int max_sweeps, cudaStream_t stream) {
  // The dynamic shared memory past the 48 KB default, once a device.
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(
        small_eigh_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(((sizeof(Shared<T>) + 15) & ~size_t(15))
            + size_t(kMaxN) * kMaxN * sizeof(T)));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const int m = S * g.P;
  const size_t bytes = ((sizeof(Shared<T>) + 15) & ~size_t(15))
                       + size_t(m) * m * sizeof(T);
  small_eigh_kernel<T, S><<<1, g.threads, bytes, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v),
      status, n, g.P, max_sweeps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, void* w, void* v, int* status, int n,
                     const Grid& g, int max_sweeps, cudaStream_t stream) {
  switch (g.S) {
    case 4: return launch<T, 4>(a, w, v, status, n, g, max_sweeps, stream);
    case 6: return launch<T, 6>(a, w, v, status, n, g, max_sweeps, stream);
    case 8: return launch<T, 8>(a, w, v, status, n, g, max_sweeps, stream);
    case 10: return launch<T, 10>(a, w, v, status, n, g, max_sweeps, stream);
    case 12: return launch<T, 12>(a, w, v, status, n, g, max_sweeps, stream);
    case 14: return launch<T, 14>(a, w, v, status, n, g, max_sweeps, stream);
    case 16: return launch<T, 16>(a, w, v, status, n, g, max_sweeps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Eigenvalues w (n,) ascending and eigenvectors v (n, n) (columns) of the
// symmetric a (n, n) row-major, 1 <= n <= 84, read from its lower
// triangle; fp64 when is_double, else fp32. On failure w and v are NaN
// and *status is set to 1; it is never cleared. Launches one block on
// `stream` (its grid from `grid_for`), allocates nothing, never
// synchronises. Returns cudaGetLastError() after the launch.
int epk_small_eigh(const void* a, void* w, void* v, void* status, int n,
                   int is_double, int max_sweeps, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const Grid g = grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* st = static_cast<int*>(status);
  if (is_double)
    return (int)dispatch<double>(a, w, v, st, n, g, max_sweeps, s);
  return (int)dispatch<float>(a, w, v, st, n, g, max_sweeps, s);
}

// The launch grid for n x n: S positions a thread (*S), P threads a row of
// V (*P); returns the block's threads (0 when n is out of range).
int epk_small_eigh_grid(int n, int* S, int* P) {
  if (n < 1 || n > kMaxN) return 0;
  const Grid g = grid_for(n);
  *S = g.S;
  *P = g.P;
  return g.threads;
}

const char* epk_small_eigh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
