// Kernel K1: all-pairs Hamming distance of packed 256-bit descriptors.
//
// Replaces vslam_tpu/ops/pallas_hamming.py::_hamming_kernel. out[i][j] =
// sum over the 8 words of popc(a[i][w] ^ b[j][w]). A block stages TM rows
// of a and TN rows of b in shared memory (b padded to 9 words a row so the
// per-thread column reads fall on distinct banks); each of the TX x TY
// threads keeps its TN/TX columns of b in registers and writes
// (TM/TY) x (TN/TX) outputs. Warps write 32 consecutive int32 of a row,
// so stores coalesce. Ragged edges are masked: no divisibility demands.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;
constexpr int TN = 128;
constexpr int TX = 32;
constexpr int TY = 8;

__global__ void __launch_bounds__(TX * TY)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n1, int n2) {
  __shared__ uint32_t sa[TM][8];
  __shared__ uint32_t sb[TN][9];
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < TM * 8; i += TX * TY) {
    const int r = i >> 3, w = i & 7;
    sa[r][w] = (row0 + r < n1) ? a[(size_t)(row0 + r) * 8 + w] : 0u;
  }
  for (int i = tid; i < TN * 8; i += TX * TY) {
    const int r = i >> 3, w = i & 7;
    sb[r][w] = (col0 + r < n2) ? b[(size_t)(col0 + r) * 8 + w] : 0u;
  }
  __syncthreads();

  uint32_t bw[TN / TX][8];
#pragma unroll
  for (int j = 0; j < TN / TX; ++j) {
#pragma unroll
    for (int w = 0; w < 8; ++w) bw[j][w] = sb[threadIdx.x + TX * j][w];
  }
#pragma unroll
  for (int i = 0; i < TM / TY; ++i) {
    const int lr = threadIdx.y + TY * i;
    const int r = row0 + lr;
    if (r >= n1) break;
    uint32_t aw[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) aw[w] = sa[lr][w];
    int32_t* orow = out + (size_t)r * n2;
#pragma unroll
    for (int j = 0; j < TN / TX; ++j) {
      const int c = col0 + threadIdx.x + TX * j;
      if (c < n2) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += __popc(aw[w] ^ bw[j][w]);
        orow[c] = s;
      }
    }
  }
}

}  // namespace

extern "C" int vslam_hamming(const void* a, const void* b, void* out, int n1,
                             int n2, void* stream) {
  if (n1 > 0 && n2 > 0) {
    const dim3 grid((n2 + TN - 1) / TN, (n1 + TM - 1) / TM);
    hamming_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<int32_t*>(out), n1, n2);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vslam_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
