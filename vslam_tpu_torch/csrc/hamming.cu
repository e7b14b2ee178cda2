// Kernel K1: all-pairs Hamming distance of packed 256-bit descriptors.
//
// Replaces vslam_tpu/ops/pallas_hamming.py:50 (_hamming_kernel): out[i][j]
// = sum over the 8 words of popc(a[i][w] ^ b[j][w]).
//
// What bounds it on an H100: writing the (n1, n2) int32 matrix. At 3072 x
// 3072 that is 37.75 MB, plus 0.2 MB of descriptors read: 11.3 us at 3.35
// TB/s. The bit work is 3072^2 x 256 AND + popc, ~2.4 us on the b1 tensor
// cores. With one __popc per word instead (8 per output, 75.5 M at 3072^2,
// at 16 per SM per clock) it needs ~18-20 us on 132 SMs before a byte is
// written, so it could never reach the write bound.
//
// Design: one mma.sync m16n8k256 on b1 operands with .and.popc gives a 16 x
// 8 block of popc(a & b) over whole 256-bit descriptors. The (N, 8) int32
// rows are, as they lie in memory, the row-major A and the column-major B of
// k = 256: lane (g, t) holds words t and t + 4 of rows g and g + 8 of A and
// of column g of B, the same k mapping on both sides. Then d = |a| + |b| -
// 2 popc(a & b), with |a| and |b| summed once per fragment by shuffles. A
// block of 8 warps computes a 16 x 128 tile (each warp 16 x 16), stages it
// in shared memory (row pitch 136 words, so each half-warp's 8-byte
// fragment writes hit 32 distinct banks) and writes it row by row with
// 16-byte stores: a warp stores one 512-byte row, four full 128-byte lines.
// Small tiles keep many blocks resident (8.7 KB of shared memory each), so
// the stores of one block overlap the loads and mma of the next. Ragged
// edges are masked with no padding demanded: rows and columns past n1 / n2
// load zero descriptors and are not stored, and when n2 is not a multiple
// of 4 (rows not 16-byte aligned) the tile is written with scalar stores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 16;               // rows of a per block: one mma's rows
constexpr int BN = 128;              // rows of b (output columns) per block
constexpr int THREADS = 256;         // 8 warps of 16 columns: 2 mma each
constexpr int WN = BN / (THREADS / 32);
constexpr int PITCH = BN + 8;        // staged tile row pitch, in words
constexpr unsigned FULL = 0xffffffffu;
static_assert(BN == 4 * 32, "a warp stores a tile row, 16 bytes a lane");

__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

// Sum of v over the 4 lanes of a quad (lanes 4g .. 4g + 3).
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

__global__ void __launch_bounds__(THREADS)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n1, int n2) {
  __shared__ __align__(16) int32_t tile[BM * PITCH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int wc = warp * WN;

  // A fragment: a[0] = row g words t (k = 32t..), a[1] = row g + 8 words t,
  // a[2] / a[3] = the same rows, words t + 4 (k = 128 + 32t..)
  const int ra = row0 + g, rb = ra + 8;
  uint32_t fa[4] = {0u, 0u, 0u, 0u};
  if (ra < n1) {
    fa[0] = __ldg(a + (size_t)ra * 8 + t);
    fa[2] = __ldg(a + (size_t)ra * 8 + t + 4);
  }
  if (rb < n1) {
    fa[1] = __ldg(a + (size_t)rb * 8 + t);
    fa[3] = __ldg(a + (size_t)rb * 8 + t + 4);
  }
  const int pa0 = quad_sum(__popc(fa[0]) + __popc(fa[2]));  // |a| of row g
  const int pa1 = quad_sum(__popc(fa[1]) + __popc(fa[3]));  // of row g + 8

#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int cn = wc + 8 * j;
    const int c = col0 + cn + g;
    uint32_t b0 = 0u, b1 = 0u;        // B fragment: column g, words t, t + 4
    if (c < n2) {
      b0 = __ldg(b + (size_t)c * 8 + t);
      b1 = __ldg(b + (size_t)c * 8 + t + 4);
    }
    const int pc = quad_sum(__popc(b0) + __popc(b1));      // |b| of column g
    // the accumulator holds columns 2t and 2t + 1, whose |b| sit in quads
    // 2t and 2t + 1
    const int pc0 = __shfl_sync(FULL, pc, 8 * t);
    const int pc1 = __shfl_sync(FULL, pc, 8 * t + 4);
    int acc[4];
    mma_and_popc(acc, fa, b0, b1);
    *reinterpret_cast<int2*>(&tile[g * PITCH + cn + 2 * t]) =
        make_int2(pa0 + pc0 - 2 * acc[0], pa0 + pc1 - 2 * acc[1]);
    *reinterpret_cast<int2*>(&tile[(g + 8) * PITCH + cn + 2 * t]) =
        make_int2(pa1 + pc0 - 2 * acc[2], pa1 + pc1 - 2 * acc[3]);
  }
  __syncthreads();

  const bool vec = (n2 & 3) == 0;
  const int c = col0 + 4 * lane;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int gr = row0 + r;
    if (gr >= n1 || c >= n2) break;
    const int4 v = *reinterpret_cast<const int4*>(&tile[r * PITCH + 4 * lane]);
    int32_t* o = out + (size_t)gr * n2 + c;
    if (vec) {
      *reinterpret_cast<int4*>(o) = v;
    } else {                           // rows not 16-byte aligned: scalars
      o[0] = v.x;
      if (c + 1 < n2) o[1] = v.y;
      if (c + 2 < n2) o[2] = v.z;
      if (c + 3 < n2) o[3] = v.w;
    }
  }
}

}  // namespace

extern "C" int vslam_hamming(const void* a, const void* b, void* out, int n1,
                             int n2, void* stream) {
  if (n1 > 0 && n2 > 0) {
    const dim3 grid((n2 + BN - 1) / BN, (n1 + BM - 1) / BM);
    hamming_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<int32_t*>(out), n1, n2);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vslam_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
