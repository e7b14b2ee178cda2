// Kernel K2: search-by-projection association, both tiers in one pass.
//
// Replaces vslam_tpu/ops/pallas_associate.py::_kernel. Semantics are those
// of vslam_tpu.mapping.point_map.associate (XLA path): for each free
// keypoint, the lexicographic (Hamming distance, map id) minimum over
//   tier 1: visible points within r_sq pixels at distance < hmax, or
//   tier 2: visible points last seen 1..max_age frames ago, within rq_sq
//           pixels at distance < rq_hmax,
// where the distance is the min over the point's occupied archive slots
// (min(desc_count, K)) of popc(a ^ b) over 8 words.
//
// Grid (keypoint tile x map chunk). A block stages its chunk's projected
// pixels and flags in shared memory; each thread owns one keypoint, sweeps
// the chunk (broadcast shared-memory reads) and reads the archive only for
// pairs inside the pixel gate. The chunk's best packed key d * 2^18 + id
// per keypoint goes to the (N,) output, pre-filled with NO_KEY, through
// atomicMin: the minimum is order-free, so the result is deterministic.
// Chunks that start past the insert cursor (read on the device) exit at
// once. Squared pixel distances use __fmul_rn/__fadd_rn so no FMA
// contraction changes a gate decision against the plain torch version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KT = 128;        // keypoints per block (one per thread)
constexpr int CHUNK = 2048;    // map points per block
constexpr int NO_KEY = 1 << 30;
constexpr int BIG = 1 << 14;
constexpr int ID_BITS = 18;

__global__ void __launch_bounds__(KT)
associate_kernel(const float2* __restrict__ muv,
                 const uint8_t* __restrict__ vis,
                 const int32_t* __restrict__ last_seen,
                 const int32_t* __restrict__ dcount,
                 const uint4* __restrict__ desc,        // (C*K, 2) uint4
                 const int32_t* __restrict__ size_ptr,
                 const int32_t* __restrict__ frame_ptr,
                 const float2* __restrict__ kp_uv,
                 const uint8_t* __restrict__ kp_free,
                 const uint4* __restrict__ kp_desc,     // (N, 2) uint4
                 int32_t* __restrict__ out_key,
                 int C, int N, int K, float r_sq, int hmax, float rq_sq,
                 int rq_hmax, int max_age) {
  const int c0 = blockIdx.y * CHUNK;
  const int size = *size_ptr;
  if (c0 >= size) return;                       // chunk past the cursor
  const int n_pts = min(CHUNK, C - c0);

  __shared__ float2 s_uv[CHUNK];
  __shared__ int s_flag[CHUNK];   // bit0 visible, bit1 recent, >>2 slots
  const int frame = max_age > 0 ? *frame_ptr : 0;
  for (int i = threadIdx.x; i < n_pts; i += KT) {
    const int row = c0 + i;
    int f = 0;
    if (vis[row]) {
      f = 1;
      if (max_age > 0) {
        const int age = frame - last_seen[row];
        if (age >= 1 && age <= max_age) f |= 2;
      }
      f |= max(0, min(dcount[row], K)) << 2;
    }
    s_uv[i] = muv[row];
    s_flag[i] = f;
  }
  __syncthreads();

  const int k = blockIdx.x * KT + threadIdx.x;
  if (k >= N || !kp_free[k]) return;
  const float2 p = kp_uv[k];
  const uint4 qa = kp_desc[2 * k], qb = kp_desc[2 * k + 1];
  int best = NO_KEY;
  for (int i = 0; i < n_pts; ++i) {
    const int f = s_flag[i];
    if (!(f & 1)) continue;
    const float2 m = s_uv[i];
    const float du = __fsub_rn(m.x, p.x);
    const float dv = __fsub_rn(m.y, p.y);
    const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
    const bool near = d2 <= r_sq;
    const bool near_rq = (f & 2) && d2 <= rq_sq;
    if (!near && !near_rq) continue;
    const int slots = f >> 2;
    const uint4* row = desc + (size_t)(c0 + i) * K * 2;
    int ham = BIG;
    for (int s = 0; s < slots; ++s) {
      const uint4 a = __ldg(row + 2 * s);
      const uint4 b = __ldg(row + 2 * s + 1);
      const int d = __popc(a.x ^ qa.x) + __popc(a.y ^ qa.y) +
                    __popc(a.z ^ qa.z) + __popc(a.w ^ qa.w) +
                    __popc(b.x ^ qb.x) + __popc(b.y ^ qb.y) +
                    __popc(b.z ^ qb.z) + __popc(b.w ^ qb.w);
      ham = min(ham, d);
    }
    if ((near && ham < hmax) || (near_rq && ham < rq_hmax)) {
      best = min(best, ham * (1 << ID_BITS) + (c0 + i));
    }
  }
  if (best < NO_KEY) atomicMin(out_key + k, best);
}

}  // namespace

extern "C" int vslam_associate(const void* muv, const void* vis,
                               const void* last_seen, const void* dcount,
                               const void* desc, const void* size,
                               const void* frame, const void* kp_uv,
                               const void* kp_free, const void* kp_desc,
                               void* out_key, int C, int N, int K, float r_sq,
                               int hmax, float rq_sq, int rq_hmax,
                               int max_age, void* stream) {
  if (C > 0 && N > 0) {
    const dim3 grid((N + KT - 1) / KT, (C + CHUNK - 1) / CHUNK);
    associate_kernel<<<grid, KT, 0, (cudaStream_t)stream>>>(
        static_cast<const float2*>(muv), static_cast<const uint8_t*>(vis),
        static_cast<const int32_t*>(last_seen),
        static_cast<const int32_t*>(dcount), static_cast<const uint4*>(desc),
        static_cast<const int32_t*>(size), static_cast<const int32_t*>(frame),
        static_cast<const float2*>(kp_uv),
        static_cast<const uint8_t*>(kp_free),
        static_cast<const uint4*>(kp_desc), static_cast<int32_t*>(out_key),
        C, N, K, r_sq, hmax, rq_sq, rq_hmax, max_age);
  }
  return (int)cudaGetLastError();
}
