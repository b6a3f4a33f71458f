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
// a template parameter, so every loop over n and m unrolls and a row's state
// (x n, z m, u m, q n: 78 + 16 floats at T = 8) stays in registers for all
// sweeps. Only T = 8, the horizon the repository uses, is instantiated.
//
// What bounds it on this card: one sweep is 2 (m n + n n + m n) = 2,496 FLOP
// per row at T = 8 plus ~8 m elementwise operations, and a row reads 64 B and
// writes 72 B once, so it is bound by operations (f32 FMA, no tensor cores),
// never by memory. The design keeps the whole iteration on chip: one thread
// owns one goal row, its state in registers, and the family's A, Kinv, lo and
// hi (~3.1 KB) are staged once per block in shared memory, where every
// thread of a warp reads the same word (a broadcast), four at a time as
// float4. blockIdx.y is the family, so one launch serves one large family
// (the table generator, F = 1) or many one-row families (the planner,
// F = lanes, G = 1).
//
// Numerics: plain f32 FMAs only, no tensor cores and no TF32: lower
// precision stalls ADMM at r_prim ~1e-2. No fast-math.
//
// Ragged tails: rows past G take part in staging and then return; nothing is
// padded or copied. There is no padding of m and no residual lane block.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128;  // goal rows per block

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);  // jnp.clip / torch: min(max(v, lo), hi)
}

// Shared-memory loads that neither compiler may merge or hoist: left to itself
// nvcc keeps the family's matrices (752 floats) in registers across the sweep
// loop, which spills. Each sweep reads them again instead, as broadcasts.
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

__device__ __forceinline__ float lds(const float* p) {
  float v;
  asm volatile("ld.volatile.shared.f32 %0, [%1];"
               : "=f"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

template <int T>
__global__ void __launch_bounds__(kMaxThreads)
admm_solve_kernel(const float* __restrict__ q,      // (F, G, N)
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
  static_assert(N % 4 == 0, "rows of A and Kinv are read as float4");
  __shared__ __align__(16) float As[M * N];
  __shared__ __align__(16) float Ks[N * N];
  __shared__ float los[M];
  __shared__ float his[M];

  const int f = blockIdx.y;
  const int tid = threadIdx.x;
  {
    const float* Af = A + (size_t)f * M * N;
    const float* Kf = kinv + (size_t)f * N * N;
    for (int i = tid; i < M * N; i += blockDim.x) As[i] = Af[i];
    for (int i = tid; i < N * N; i += blockDim.x) Ks[i] = Kf[i];
    for (int i = tid; i < M; i += blockDim.x) {
      los[i] = lo[(size_t)f * M + i];
      his[i] = hi[(size_t)f * M + i];
    }
  }
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + tid;
  if (g >= G) return;  // no barrier follows

  const float rho = rho_f[f];
  const float beta = 1.0f - alpha;
  const size_t row = (size_t)f * G + g;

  float qr[N];
  {
    const float4* q4 = reinterpret_cast<const float4*>(q + row * N);
#pragma unroll
    for (int c = 0; c < N4; ++c) {
      const float4 v = q4[c];
      qr[4 * c] = v.x; qr[4 * c + 1] = v.y; qr[4 * c + 2] = v.z; qr[4 * c + 3] = v.w;
    }
  }
  float x[N], z[M], u[M];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    z[j] = clipf(0.0f, los[j], his[j]);
    u[j] = 0.0f;
  }

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // rhs = sigma x - q + (rho (z - u)) A
    float rhs[N];
#pragma unroll
    for (int i = 0; i < N; ++i) rhs[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float w = rho * (z[j] - u[j]);
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        const float4 a = lds4(As + j * N + 4 * c);
        rhs[4 * c] = fmaf(w, a.x, rhs[4 * c]);
        rhs[4 * c + 1] = fmaf(w, a.y, rhs[4 * c + 1]);
        rhs[4 * c + 2] = fmaf(w, a.z, rhs[4 * c + 2]);
        rhs[4 * c + 3] = fmaf(w, a.w, rhs[4 * c + 3]);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) rhs[i] = (sigma * x[i] - qr[i]) + rhs[i];
    // x = rhs Kinv^T: x_i = sum_k Kinv[i][k] rhs_k
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        const float4 k = lds4(Ks + i * N + 4 * c);
        acc = fmaf(k.x, rhs[4 * c], acc);
        acc = fmaf(k.y, rhs[4 * c + 1], acc);
        acc = fmaf(k.z, rhs[4 * c + 2], acc);
        acc = fmaf(k.w, rhs[4 * c + 3], acc);
      }
      x[i] = acc;
    }
    // ax = alpha (x A^T) + (1 - alpha) z; z = clip(ax + u); u += ax - z
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        const float4 a = lds4(As + j * N + 4 * c);
        acc = fmaf(x[4 * c], a.x, acc);
        acc = fmaf(x[4 * c + 1], a.y, acc);
        acc = fmaf(x[4 * c + 2], a.z, acc);
        acc = fmaf(x[4 * c + 3], a.w, acc);
      }
      const float ax = alpha * acc + beta * z[j];
      const float zn = clipf(ax + u[j], lds(los + j), lds(his + j));
      u[j] = (u[j] + ax) - zn;
      z[j] = zn;
    }
  }

  // residuals of the final iterate; the dual one from the change in z
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
      acc = fmaf(x[4 * c], a.x, acc);
      acc = fmaf(x[4 * c + 1], a.y, acc);
      acc = fmaf(x[4 * c + 2], a.z, acc);
      acc = fmaf(x[4 * c + 3], a.w, acc);
    }
    const float zn = clipf(acc + u[j], lds(los + j), lds(his + j));
    rp = fmaxf(rp, fabsf(acc - zn));
    const float dz = zn - z[j];
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

  float4* xo = reinterpret_cast<float4*>(x_out + row * N);
#pragma unroll
  for (int c = 0; c < N4; ++c)
    xo[c] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
  r_prim[row] = rp;
  r_dual[row] = rho * dmax;
}

template <int T>
int launch(const float* q, const float* A, const float* kinv, const float* lo,
           const float* hi, const float* rho, float* x, float* r_prim,
           float* r_dual, int F, int G, int iters, float sigma, float alpha,
           cudaStream_t stream) {
  const int threads = G < kMaxThreads ? ((G + 31) / 32) * 32 : kMaxThreads;
  const dim3 grid((G + threads - 1) / threads, F);
  admm_solve_kernel<T><<<grid, threads, 0, stream>>>(
      q, A, kinv, lo, hi, rho, x, r_prim, r_dual, G, iters, sigma, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is a contiguous f32 device array with the shape noted at
// admm_solve_kernel (N = 2T, M = 4T - 1); q and x_out rows are 16-byte
// aligned. The Python wrapper checks shapes, types and devices.
extern "C" int admm_solve_f32(const float* q, const float* A, const float* kinv,
                              const float* lo, const float* hi, const float* rho,
                              float* x, float* r_prim, float* r_dual, int F, int G,
                              int T, int iters, float sigma, float alpha,
                              void* stream) {
  if (F <= 0 || G <= 0) return 0;
  if (F > 65535 || iters < 0) return (int)cudaErrorInvalidValue;
  switch (T) {
    case 8:
      return launch<8>(q, A, kinv, lo, hi, rho, x, r_prim, r_dual, F, G, iters,
                       sigma, alpha, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
