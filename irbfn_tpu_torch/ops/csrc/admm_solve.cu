// Box-QP ADMM over goal families that share one factorization, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel irbfn_tpu/ops/pallas_admm.py:_admm_kernel (wrapper
// admm_solve_pallas, called from solvers/goal_mpc.py:solve_goal_family_pallas).
// It computes the same function, not the same blocks. For family f and goal
// row g, in f32, with the family's A (m, n), Kinv (n, n), lo, hi (m) and rho:
//
//   x = 0; z = clip(0, lo, hi); u = 0
//   repeat iters times:
//       rhs = sigma x - q + (rho (z - u)) A
//       x   = rhs Kinv^T
//       ax  = alpha (x A^T) + (1 - alpha) z
//       z   = clip(ax + u, lo, hi);  u = u + ax - z
//   ax = x A^T;  zn = clip(ax + u, lo, hi)
//   r_prim = max_j |ax_j - zn_j|;  r_dual = rho max_i |((zn - z) A)_i|
//
// n = 2T controls and m = 4T - 1 constraint rows for an MPC horizon T; T is
// a template parameter and only T = 8 (n = 16, m = 31), the horizon the
// repository uses, is instantiated.
//
// What bounds it on this card: one sweep is 2 (m n + n n + m n) = 2,496 FLOP
// per row plus ~8 m elementwise operations, and a row reads 64 B and writes
// 72 B once, so it is bound by operations (f32 FMA outside the tensor
// cores), never by memory. An SM starts four warp instructions a clock and
// each can be an FMA, so whatever else a sweep executes (loads of the
// matrices, the clip and the dual update) is taken from the FMA rate; and a
// row's 600 sweeps are one dependent chain, so a launch needs either many
// rows in flight or a short chain. Two variants, picked by the caller from
// (F, G) (irbfn_tpu_torch/ops/admm.py:admm_variant):
//
// - family (kFamily), many goal rows per family: the table generator, F = 1.
//   A thread owns ADMM_FAMILY_ROWS = 2 goal rows, their x, z, u (156 floats)
//   in registers for all sweeps. The family's A, Kinv, lo and hi (3.3 KB)
//   are staged once per block in shared memory, where every thread of a
//   warp reads the same 16 bytes (a broadcast): one ld.shared.v4 feeds 8
//   FMAs, which keeps the load pipe (one warp instruction a clock per SM)
//   well under the FMA pipes' four. The rows' q (2 x 64 B a thread) also
//   sits in shared memory, each thread reading its own slots. 250
//   registers, no spills: 2 blocks of 128 threads per SM. Per two rows a
//   sweep executes 3,394 instructions: the products' 2,496 FFMA, 336 loads
//   and ~560 for the relaxation, the clip and the dual update, so the FMA
//   pipes can reach 74% of their peak; measured 63% on an H100
//   (scripts/tune_admm_family.py; the block shape does not matter, one row
//   per thread loads twice as much per FMA and is 1.4x slower, three rows
//   spill). blockIdx.y is the family.
//   The matrices must be read by loads the compiler cannot hoist
//   (ld.volatile): left to itself it keeps all 814 loop-invariant floats in
//   registers across the sweep loop and spills them. For the same reason
//   __constant__ memory does not serve: the compiler loads the constants
//   into registers ahead of the loop instead of taking them as FMA
//   operands, and spills (3.5 KB a thread, 11x slower, measured).
// - lane (kLane), few rows per family, many families: the planner, one goal
//   row for each of 1000 lanes, each with its own matrices. A warp owns one
//   goal row, so 600 sweeps are 600 short steps instead of 600 long ones.
//   Lane j < 31 owns constraint row j (z_j, u_j, lo_j, hi_j and A's row j
//   in registers); lane l also owns control i = l mod 16 together with lane
//   l xor 16: each of the two holds half of A's column i and half of Kinv's
//   row i and sums its half, and one shuffle joins the halves. The three
//   vectors (rho (z - u), rhs, x) pass between lanes through a 256-byte
//   strip of shared memory per warp, fenced by __syncwarp. Every row loads
//   its own family's matrices once (40 floats a lane), so nothing is shared
//   across warps and any (F, G) is served. 72 registers, 4 rows per block.
//   A sweep is a chain of ~380 clocks (three shared-memory round trips, two
//   shuffles, ~40 dependent FMAs): 0.12-0.13 ms for 600 sweeps of up to
//   ~1000 rows, then ~0.065 us a row.
//
// Numerics: plain f32 FMAs only, no tensor cores and no TF32: lower
// precision stalls ADMM at r_prim ~1e-2. No fast-math. The two variants sum
// their products in different orders (the lane variant in partial chains
// of four), so two solves of one problem by different variants differ as
// any two f32 ADMM paths do; one variant on one input is bitwise repeatable.
//
// Ragged tails: a thread's rows past G are computed on zeros and never
// written (family); a warp past the last row leaves at once (lane). Nothing
// is padded or copied.

#include <cuda_runtime.h>

#ifndef ADMM_FAMILY_ROWS
#define ADMM_FAMILY_ROWS 2  // goal rows per thread of the family variant
#endif
#ifndef ADMM_FAMILY_THREADS
#define ADMM_FAMILY_THREADS 128
#endif
#ifndef ADMM_FAMILY_BLOCKS
#define ADMM_FAMILY_BLOCKS 2  // resident blocks per SM the registers allow
#endif

namespace {

constexpr int kFamily = 0;
constexpr int kLane = 1;
constexpr int kFamilyRows = ADMM_FAMILY_ROWS;
constexpr int kFamilyThreads = ADMM_FAMILY_THREADS;
constexpr int kLaneWarps = 4;  // goal rows per block of the lane variant

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);  // jnp.clip / torch: min(max(v, lo), hi)
}

// A shared-memory load that the compiler may neither merge nor hoist out of
// the sweep loop: hoisted, the loop-invariant values (the family's 814
// floats, the rows' q) would live in registers for all sweeps and spill.
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

// ------------------------------------------------------------ family variant

template <int T>
__global__ void __launch_bounds__(kFamilyThreads, ADMM_FAMILY_BLOCKS)
admm_solve_kernel_family(const float* __restrict__ q,      // (F, G, N)
                         const float* __restrict__ A,      // (F, M, N)
                         const float* __restrict__ kinv,   // (F, N, N)
                         const float* __restrict__ lo,     // (F, M)
                         const float* __restrict__ hi,     // (F, M)
                         const float* __restrict__ rho_f,  // (F,)
                         float* __restrict__ x_out,        // (F, G, N)
                         float* __restrict__ r_prim,       // (F, G)
                         float* __restrict__ r_dual,       // (F, G)
                         int G, int iters, float sigma, float alpha) {
  constexpr int N = 2 * T;
  constexpr int M = 4 * T - 1;
  constexpr int N4 = N / 4;
  constexpr int M4 = (M + 3) / 4;  // lo and hi, padded to float4s
  constexpr int R = kFamilyRows;
  static_assert(N % 4 == 0, "rows of q, x, A and Kinv are moved as float4");
  __shared__ __align__(16) float As[M * N];
  __shared__ __align__(16) float Ks[N * N];
  __shared__ __align__(16) float los[4 * M4];
  __shared__ __align__(16) float his[4 * M4];
  __shared__ __align__(16) float qs[R][N4][kFamilyThreads][4];

  const int f = blockIdx.y;
  const int tid = threadIdx.x;
  {
    const float* Af = A + (size_t)f * M * N;
    const float* Kf = kinv + (size_t)f * N * N;
    for (int i = tid; i < M * N; i += kFamilyThreads) As[i] = Af[i];
    for (int i = tid; i < N * N; i += kFamilyThreads) Ks[i] = Kf[i];
    for (int i = tid; i < 4 * M4; i += kFamilyThreads) {
      los[i] = i < M ? lo[(size_t)f * M + i] : 0.0f;
      his[i] = i < M ? hi[(size_t)f * M + i] : 0.0f;
    }
  }
  __syncthreads();
  // row r of this thread is goal g0 + r * kFamilyThreads of family f
  const int g0 = blockIdx.x * (kFamilyThreads * R) + tid;
  if (g0 >= G) return;  // no barrier follows; a thread's rows ascend
  const size_t row0 = (size_t)f * G;

  // q: every thread keeps its rows' 16 floats in its own slots
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = g0 + r * kFamilyThreads;
    live[r] = g < G;
    const float4* q4 = reinterpret_cast<const float4*>(q + (row0 + g) * N);
#pragma unroll
    for (int c = 0; c < N4; ++c)
      *reinterpret_cast<float4*>(qs[r][c][tid]) =
          live[r] ? q4[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float rho = rho_f[f];
  const float beta = 1.0f - alpha;
  float x[R][N], z[R][M], u[R][M];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[r][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      z[r][j] = clipf(0.0f, los[j], his[j]);
      u[r][j] = 0.0f;
    }
  }

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // rhs = sigma x - q + (rho (z - u)) A
    float rhs[R][N];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < N; ++i) rhs[r][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = rho * (z[r][j] - u[r][j]);
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        const float4 a = lds4(As + j * N + 4 * c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          rhs[r][4 * c] = fmaf(w[r], a.x, rhs[r][4 * c]);
          rhs[r][4 * c + 1] = fmaf(w[r], a.y, rhs[r][4 * c + 1]);
          rhs[r][4 * c + 2] = fmaf(w[r], a.z, rhs[r][4 * c + 2]);
          rhs[r][4 * c + 3] = fmaf(w[r], a.w, rhs[r][4 * c + 3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        const float4 qv = lds4(qs[r][c][tid]);
        rhs[r][4 * c] = (sigma * x[r][4 * c] - qv.x) + rhs[r][4 * c];
        rhs[r][4 * c + 1] = (sigma * x[r][4 * c + 1] - qv.y) + rhs[r][4 * c + 1];
        rhs[r][4 * c + 2] = (sigma * x[r][4 * c + 2] - qv.z) + rhs[r][4 * c + 2];
        rhs[r][4 * c + 3] = (sigma * x[r][4 * c + 3] - qv.w) + rhs[r][4 * c + 3];
      }
    // x = rhs Kinv^T: x_i = sum_k Kinv[i][k] rhs_k
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        const float4 k = lds4(Ks + i * N + 4 * c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r] = fmaf(k.x, rhs[r][4 * c], acc[r]);
          acc[r] = fmaf(k.y, rhs[r][4 * c + 1], acc[r]);
          acc[r] = fmaf(k.z, rhs[r][4 * c + 2], acc[r]);
          acc[r] = fmaf(k.w, rhs[r][4 * c + 3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) x[r][i] = acc[r];
    }
    // ax = alpha (x A^T) + (1 - alpha) z; z = clip(ax + u); u += ax - z
    float lo4[4], hi4[4];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j % 4 == 0) {
        const float4 l = lds4(los + j), h = lds4(his + j);
        lo4[0] = l.x; lo4[1] = l.y; lo4[2] = l.z; lo4[3] = l.w;
        hi4[0] = h.x; hi4[1] = h.y; hi4[2] = h.z; hi4[3] = h.w;
      }
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        const float4 a = lds4(As + j * N + 4 * c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r] = fmaf(x[r][4 * c], a.x, acc[r]);
          acc[r] = fmaf(x[r][4 * c + 1], a.y, acc[r]);
          acc[r] = fmaf(x[r][4 * c + 2], a.z, acc[r]);
          acc[r] = fmaf(x[r][4 * c + 3], a.w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ax = alpha * acc[r] + beta * z[r][j];
        const float zn = clipf(ax + u[r][j], lo4[j % 4], hi4[j % 4]);
        u[r][j] = (u[r][j] + ax) - zn;
        z[r][j] = zn;
      }
    }
  }

  // residuals of the final iterate; the dual one from the change in z
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float rp = 0.0f;
    float rd[N];
#pragma unroll
    for (int i = 0; i < N; ++i) rd[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        const float4 a = lds4(As + j * N + 4 * c);
        acc = fmaf(x[r][4 * c], a.x, acc);
        acc = fmaf(x[r][4 * c + 1], a.y, acc);
        acc = fmaf(x[r][4 * c + 2], a.z, acc);
        acc = fmaf(x[r][4 * c + 3], a.w, acc);
      }
      const float zn = clipf(acc + u[r][j], los[j], his[j]);
      rp = fmaxf(rp, fabsf(acc - zn));
      const float dz = zn - z[r][j];
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        const float4 a = lds4(As + j * N + 4 * c);
        rd[4 * c] = fmaf(dz, a.x, rd[4 * c]);
        rd[4 * c + 1] = fmaf(dz, a.y, rd[4 * c + 1]);
        rd[4 * c + 2] = fmaf(dz, a.z, rd[4 * c + 2]);
        rd[4 * c + 3] = fmaf(dz, a.w, rd[4 * c + 3]);
      }
    }
    float dmax = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) dmax = fmaxf(dmax, fabsf(rd[i]));
    if (live[r]) {
      const size_t row = row0 + g0 + r * kFamilyThreads;
      float4* xo = reinterpret_cast<float4*>(x_out + row * N);
#pragma unroll
      for (int c = 0; c < N4; ++c)
        xo[c] = make_float4(x[r][4 * c], x[r][4 * c + 1], x[r][4 * c + 2],
                            x[r][4 * c + 3]);
      r_prim[row] = rp;
      r_dual[row] = rho * dmax;
    }
  }
}

// -------------------------------------------------------------- lane variant

// sum_{k < 4 C} a[k] v[k] as C chains of four FMAs, joined pairwise
template <int C>
__device__ __forceinline__ float dot_chains(const float* a, const float4* v) {
  float p[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4 t = v[c];
    p[c] = a[4 * c] * t.x;
    p[c] = fmaf(a[4 * c + 1], t.y, p[c]);
    p[c] = fmaf(a[4 * c + 2], t.z, p[c]);
    p[c] = fmaf(a[4 * c + 3], t.w, p[c]);
  }
#pragma unroll
  for (int s = 1; s < C; s *= 2)
#pragma unroll
    for (int c = 0; c + s < C; c += 2 * s) p[c] += p[c + s];
  return p[0];
}

template <int T>
__global__ void __launch_bounds__(kLaneWarps * 32)
admm_solve_kernel_lane(const float* __restrict__ q,      // (F, G, N)
                       const float* __restrict__ A,      // (F, M, N)
                       const float* __restrict__ kinv,   // (F, N, N)
                       const float* __restrict__ lo,     // (F, M)
                       const float* __restrict__ hi,     // (F, M)
                       const float* __restrict__ rho_f,  // (F,)
                       float* __restrict__ x_out,        // (F, G, N)
                       float* __restrict__ r_prim,       // (F, G)
                       float* __restrict__ r_dual,       // (F, G)
                       long long rows, int G, int iters, float sigma,
                       float alpha) {
  constexpr int N = 2 * T;
  constexpr int M = 4 * T - 1;
  constexpr int H = N / 2;  // the share of Kinv's row one lane sums
  static_assert(M + 1 == 32 && N == 16,
                "the lane variant maps m + 1 constraint rows and two halves "
                "of n controls onto the 32 lanes of a warp");
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ __align__(16) float strips[kLaneWarps][2 * 32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kLaneWarps + warp;
  if (row >= rows) return;  // the whole warp; only __syncwarp follows
  const int f = (int)(row / G);
  const float* Af = A + (size_t)f * M * N;
  const float* Kf = kinv + (size_t)f * N * N;

  // constraint row j = lane (lane 31 holds a row of zeros between 0 and 0)
  const bool has_row = lane < M;
  float ar[N];
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 v = has_row
        ? reinterpret_cast<const float4*>(Af + lane * N)[c]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    ar[4 * c] = v.x; ar[4 * c + 1] = v.y; ar[4 * c + 2] = v.z; ar[4 * c + 3] = v.w;
  }
  const float lo_j = has_row ? lo[(size_t)f * M + lane] : 0.0f;
  const float hi_j = has_row ? hi[(size_t)f * M + lane] : 0.0f;
  // control i = lane mod 16; this lane sums rows 16 h .. 16 h + 15 of A's
  // column i and entries 8 h .. 8 h + 7 of Kinv's row i
  const int i = lane & (N - 1);
  const int h = lane >> 4;
  float ac[N];
#pragma unroll
  for (int jj = 0; jj < N; ++jj) {
    const int j = N * h + jj;
    ac[jj] = j < M ? Af[j * N + i] : 0.0f;
  }
  float kr[H];
#pragma unroll
  for (int c = 0; c < H / 4; ++c) {
    const float4 v = reinterpret_cast<const float4*>(Kf + i * N + H * h)[c];
    kr[4 * c] = v.x; kr[4 * c + 1] = v.y; kr[4 * c + 2] = v.z; kr[4 * c + 3] = v.w;
  }
  const float qi = q[(size_t)row * N + i];
  const float rho = rho_f[f];
  const float beta = 1.0f - alpha;

  float* ws = strips[warp];  // 32: rho (z - u), then z's last change
  float* rs = ws + 32;       // 16: rhs
  float* xs = rs + N;        // 16: x
  const float4* ws_h = reinterpret_cast<const float4*>(ws + N * h);
  const float4* rs_h = reinterpret_cast<const float4*>(rs + H * h);
  const float4* xs_4 = reinterpret_cast<const float4*>(xs);

  float xi = 0.0f;
  float z = clipf(0.0f, lo_j, hi_j);
  float u = 0.0f;

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    ws[lane] = rho * (z - u);
    __syncwarp();
    float part = dot_chains<N / 4>(ac, ws_h);
    part += __shfl_xor_sync(kAll, part, 16);
    const float rhs = (sigma * xi - qi) + part;
    if (h == 0) rs[i] = rhs;
    __syncwarp();
    part = dot_chains<H / 4>(kr, rs_h);
    xi = part + __shfl_xor_sync(kAll, part, 16);
    if (h == 0) xs[i] = xi;
    __syncwarp();
    const float ax = alpha * dot_chains<N / 4>(ar, xs_4) + beta * z;
    const float zn = clipf(ax + u, lo_j, hi_j);
    u = (u + ax) - zn;
    z = zn;
  }

  // residuals of the final iterate; the dual one from the change in z
  if (h == 0) xs[i] = xi;
  __syncwarp();
  const float ax = dot_chains<N / 4>(ar, xs_4);
  const float zn = clipf(ax + u, lo_j, hi_j);
  float rp = fabsf(ax - zn);
  ws[lane] = zn - z;
  __syncwarp();
  float rd = dot_chains<N / 4>(ac, ws_h);
  rd = fabsf(rd + __shfl_xor_sync(kAll, rd, 16));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rp = fmaxf(rp, __shfl_xor_sync(kAll, rp, off));
    rd = fmaxf(rd, __shfl_xor_sync(kAll, rd, off));
  }
  if (h == 0) x_out[(size_t)row * N + i] = xi;
  if (lane == 0) {
    r_prim[row] = rp;
    r_dual[row] = rho * rd;
  }
}

template <int T>
int launch(const float* q, const float* A, const float* kinv, const float* lo,
           const float* hi, const float* rho, float* x, float* r_prim,
           float* r_dual, int F, int G, int iters, float sigma, float alpha,
           int variant, cudaStream_t stream) {
  if (variant == kFamily) {
    const int per_block = kFamilyThreads * kFamilyRows;
    if (F > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((G + per_block - 1) / per_block, F);
    admm_solve_kernel_family<T><<<grid, kFamilyThreads, 0, stream>>>(
        q, A, kinv, lo, hi, rho, x, r_prim, r_dual, G, iters, sigma, alpha);
    return (int)cudaGetLastError();
  }
  const long long rows = (long long)F * G;
  const long long blocks = (rows + kLaneWarps - 1) / kLaneWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  admm_solve_kernel_lane<T><<<(unsigned)blocks, kLaneWarps * 32, 0, stream>>>(
      q, A, kinv, lo, hi, rho, x, r_prim, r_dual, rows, G, iters, sigma,
      alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the first CUDA error (0 on success).
// Every pointer is a contiguous f32 device array with the shape noted at
// admm_solve_kernel_lane (N = 2T, M = 4T - 1); q, A, kinv and x are 16-byte
// aligned. `variant` is 0 (family) or 1 (lane). The Python wrapper checks
// shapes, types and devices.
extern "C" int admm_solve_f32(const float* q, const float* A, const float* kinv,
                              const float* lo, const float* hi, const float* rho,
                              float* x, float* r_prim, float* r_dual, int F, int G,
                              int T, int iters, float sigma, float alpha,
                              int variant, void* stream) {
  if (F <= 0 || G <= 0) return 0;
  if (iters < 0 || (variant != kFamily && variant != kLane))
    return (int)cudaErrorInvalidValue;
  switch (T) {
    case 8:
      return launch<8>(q, A, kinv, lo, hi, rho, x, r_prim, r_dual, F, G, iters,
                       sigma, alpha, variant, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Rows per block of the family variant, for callers that size a launch.
extern "C" int admm_family_rows_per_block() {
  return kFamilyThreads * kFamilyRows;
}
