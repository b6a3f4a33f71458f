// A measuring probe, not the counterpart of a TPU kernel: the card's f32
// FMA ceiling for the NMPC roofline (python -m irbfn_tpu_torch.utils.profiling
// --parts nmpc; scripts/profile_nmpc.py:measure_ceilings in the JAX package
// measured it with XLA's fused elementwise chain).
//
// Each thread runs a dependent chain of kSteps FMAs on its element,
// y <- fmaf(y, a, b), `repeats` times over in registers, and writes the
// result once. In plain PyTorch the same chain is 2 * kSteps launches that
// each stream the whole array through device memory, so it measures the
// memory, not the FMA units. Here a thread reads 4 bytes and writes 4 for
// 2 * kSteps * repeats FLOP; at repeats = 1 that is 16 FLOP a byte, under the
// H100's f32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP a byte), so the
// ceiling is taken at repeats >= 8. A single dependent chain per thread has
// the FMA's 4-cycle latency; a full SM needs 512 chains in flight (128 lanes
// x 4 cycles), 16 warps, which 256-thread blocks over millions of elements
// give.

#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long n, int repeats, float a, float b) {
  long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (; i < n; i += stride) {
    float v = x[i];
    for (int r = 0; r < repeats; ++r) {
#pragma unroll
      for (int k = 0; k < kSteps; ++k) v = fmaf(v, a, b);
    }
    y[i] = v;
  }
}

}  // namespace

extern "C" int fma_chain_steps() { return kSteps; }

extern "C" int fma_chain_f32(const float* x, float* y, long long n,
                             int repeats, float a, float b, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  fma_chain_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, n, repeats,
                                                          a, b);
  return (int)cudaGetLastError();
}
