// Kernel K2: search-by-projection association, both tiers in one pass.
//
// Replaces vslam_tpu/ops/pallas_associate.py:71 (_kernel). Semantics are
// those of vslam_tpu.mapping.point_map.associate (XLA path): for each free
// keypoint, the lexicographic (Hamming distance, map id) minimum over
//   tier 1: visible points within r_sq pixels at distance < hmax, or
//   tier 2: visible points last seen 1..max_age frames ago, within rq_sq
//           pixels at distance < rq_hmax,
// where the distance is the min over the point's occupied archive slots
// (min(desc_count, K)) of popc(a ^ b) over 8 words.
//
// What bounds it on an H100: the all-pairs pixel gate. Every (keypoint, map
// point) pair below the insert cursor costs 5 f32 operations (two
// differences, two squares, one sum) and a compare, N x size pairs in all;
// the Hamming work is for the few pairs inside the gate (~30 per keypoint on
// a KITTI-sized frame), and the bytes (the map rows below the cursor, read
// once) take a fraction of the arithmetic's time. The sweep is what costs:
// its instructions per pair, and the warps' stalls when a pair falls inside
// the gate.
//
// Design:
// - Persistent blocks (the card's resident capacity) split the (keypoint
//   tile of 512) x (map row below the insert cursor) pairs into equal
//   contiguous ranges, point-granular, walked chunk by chunk of 128 rows.
//   The cursor is read on the device; the host never reads it.
// - A chunk's pixels, visibility, last_seen and slot counts arrive by
//   cp.async while the block sweeps the previous chunk; one pass turns them
//   into 16-byte records (u, v, box half-width, slots | recent << 16) in
//   shared memory. The box holds the union of both tiers' pixel gates for
//   the point; its half-width is -1 where the point cannot match
//   (invisible, or at or past the cursor).
// - The sweep is branch-free and register-blocked: a thread holds R = 4
//   keypoints, and one broadcast read of a record serves 4 box tests of 4
//   instructions each (two differences, a max of magnitudes, a compare).
//   Only when some lane of the warp has a pair in the box (one vote per
//   record) does the warp queue the point: one lane writes the row, the
//   record and one ballot per keypoint register into the warp's queue in
//   shared memory. A queue per warp needs no atomic and no block barrier.
// - A warp drains its queue when it is full (so it drains mid-chunk and
//   never drops a point) and when its keypoint tile ends. Each queued pair
//   takes the exact gates of both tiers, with the plain version's
//   arithmetic (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction can
//   flip a decision); pairs inside go to a second per-warp list, which is
//   scored whenever it could overflow. Eight lanes score one pair: each
//   loads 16 bytes of its archive row (K = 4 slots x 32 B, coalesced), two
//   pairs per lane group in flight, with no lane waiting inside another's
//   branch; shuffles sum popc(a ^ q) per slot and take the min over
//   min(dcount, K) slots; both tiers' Hamming gates apply; the packed key
//   d * 2^18 + id goes to the keypoint's best in shared memory by
//   atomicMin.
// - When a block leaves a keypoint tile, each keypoint that found something
//   goes to the (N,) output, pre-filled with NO_KEY, by one global
//   atomicMin. The minimum is order-free, so the result is deterministic.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;               // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int R = 4;                       // keypoints per thread
constexpr int TILE = THREADS * R;          // keypoints per tile
constexpr int CH = THREADS;                // map points per staged chunk
constexpr int QE = 64;                     // queued map points per warp
constexpr int CQ = 128;                    // queued candidate pairs per warp
constexpr int SU = 2;                      // pairs per 8-lane group in flight
constexpr int NO_KEY = 1 << 30;
constexpr int BIG = 1 << 14;
constexpr int ID_BITS = 18;
constexpr unsigned FULL = 0xffffffffu;
static_assert(CH == THREADS, "the record pass gives each thread one point");
static_assert(R % 4 == 0 && R <= 16, "hit masks are stored as uint4");
static_assert(CQ >= 32, "one append round must fit an empty list");

struct __align__(16) Smem {
  float2 muv[CH];            // the chunk as it lies in memory (cp.async)
  int32_t last[CH];
  int32_t dcount[CH];
  uint8_t vis[CH];
  float4 rec[CH];            // (u, v, box half-width or -1, slots|recent<<16)
  // a map point some of the warp's keypoints may match: (row, slots |
  // recent << 16, u, v), and which: bit t of word r is keypoint
  // r * THREADS + 32 * warp + t of the tile
  uint4 head[WARPS][QE];
  uint4 hits[WARPS][QE][R / 4];
  // a pair inside a tier's pixel gate: (row | near << 30 | near_rq << 31,
  // local keypoint | slots << 16)
  uint2 cand[WARPS][CQ];
  float2 kp_uv[TILE];        // the tile's keypoints, NaN where not free
  int32_t best[TILE];        // packed key per keypoint of the tile
};

struct Gates {
  float r_sq, rq_sq;
  int hmax, rq_hmax, K;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes) : "memory");
}

// Issue the copies of chunk c0's rows into the raw arrays. Rows past the
// capacity C are zero-filled (a copy of 0 bytes from the aligned base) and
// never read.
__device__ __forceinline__ void stage(Smem& sm, int c0, int C,
                                      const float2* muv, const uint8_t* vis,
                                      const int32_t* last,
                                      const int32_t* dcount) {
  constexpr int n_uv = CH * 8 / 16, n_vis = CH / 16, n_i32 = CH * 4 / 16;
  for (int i = threadIdx.x; i < n_uv + n_vis + 2 * n_i32; i += THREADS) {
    int j = i, row, width;
    const char* src;
    char* dst;
    if (j < n_uv) {
      row = c0 + 2 * j, width = 8;
      src = reinterpret_cast<const char*>(muv + (row < C ? row : 0));
      dst = reinterpret_cast<char*>(sm.muv + 2 * j);
    } else if ((j -= n_uv) < n_vis) {
      row = c0 + 16 * j, width = 1;
      src = reinterpret_cast<const char*>(vis + (row < C ? row : 0));
      dst = reinterpret_cast<char*>(sm.vis + 16 * j);
    } else if ((j -= n_vis) < n_i32) {
      row = c0 + 4 * j, width = 4;
      src = reinterpret_cast<const char*>(last + (row < C ? row : 0));
      dst = reinterpret_cast<char*>(sm.last + 4 * j);
    } else {
      j -= n_i32;
      row = c0 + 4 * j, width = 4;
      src = reinterpret_cast<const char*>(dcount + (row < C ? row : 0));
      dst = reinterpret_cast<char*>(sm.dcount + 4 * j);
    }
    cp_async16(dst, src, max(0, min(16, (C - row) * width)));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Hamming stage: the warp's candidate pairs cand[0..cn) -> per-keypoint
// bests. Eight lanes take one pair, two pairs per group in flight.
__device__ __forceinline__ void score(const uint2* cand, int cn, int kp0,
                                      int32_t* best, const uint4* desc,
                                      const uint4* kp_desc, const Gates& g) {
  __syncwarp();
  const int lane = threadIdx.x & 31, grp = lane >> 3, l = lane & 7;
  const int half = l & 1;
  for (int b = 0; b < cn; b += 4 * SU) {
    uint2 e[SU];
    uint4 qd[SU];
    int ham[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int idx = b + 4 * u + grp;
      e[u] = idx < cn ? cand[idx] : make_uint2(0u, 0u);
      qd[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < cn)
        qd[u] = __ldg(kp_desc + 2 * (kp0 + (e[u].y & 0xffff)) + half);
      ham[u] = BIG;
    }
    for (int s0 = 0; s0 < g.K; s0 += 4) {
      const int s = s0 + (l >> 1);
      uint4 a[SU];
      bool use[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        use[u] = b + 4 * u + grp < cn && s < (int)(e[u].y >> 16);
        a[u] = make_uint4(0u, 0u, 0u, 0u);
        if (use[u]) {
          const int row = e[u].x & ((1u << ID_BITS) - 1);
          a[u] = __ldg(desc + ((size_t)row * g.K + s) * 2 + half);
        }
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        int d = __popc(a[u].x ^ qd[u].x) + __popc(a[u].y ^ qd[u].y) +
                __popc(a[u].z ^ qd[u].z) + __popc(a[u].w ^ qd[u].w);
        d += __shfl_xor_sync(FULL, d, 1);          // the slot's two halves
        if (use[u]) ham[u] = min(ham[u], d);
      }
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      int h = min(ham[u], __shfl_xor_sync(FULL, ham[u], 2));  // over slots
      h = min(h, __shfl_xor_sync(FULL, h, 4));
      if (b + 4 * u + grp < cn && l == 0) {
        const bool near = (e[u].x >> 30) & 1u, near_rq = e[u].x >> 31;
        const int row = e[u].x & ((1u << ID_BITS) - 1);
        if ((near && h < g.hmax) || (near_rq && h < g.rq_hmax))
          atomicMin(best + (e[u].y & 0xffff), h * (1 << ID_BITS) + row);
      }
    }
  }
  __syncwarp();
}

// The warp's queued map points -> candidate pairs (the exact pixel gates of
// both tiers, with the sweep's own arithmetic) -> score. All 32 lanes call.
__device__ void drain(Smem& sm, int qn, int kp0, const uint4* desc,
                      const uint4* kp_desc, const Gates& g) {
  __syncwarp();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  uint2* cand = sm.cand[warp];
  int cn = 0;                                   // warp-uniform
  for (int base = 0; base < qn; base += 32) {
    const int j = base + lane;
    uint4 h = make_uint4(0u, 0u, 0u, 0u);
    unsigned bits[R];
#pragma unroll
    for (int r = 0; r < R; ++r) bits[r] = 0u;
    if (j < qn) {
      h = sm.head[warp][j];
#pragma unroll
      for (int w = 0; w < R / 4; ++w) {
        const uint4 m = sm.hits[warp][j][w];
        bits[4 * w] = m.x, bits[4 * w + 1] = m.y;
        bits[4 * w + 2] = m.z, bits[4 * w + 3] = m.w;
      }
    }
    const float mu = __uint_as_float(h.z), mv = __uint_as_float(h.w);
    const bool recent = (h.y >> 16) & 1u;
    while (true) {                              // one pair per lane a round
      int rs = -1, ts = 0;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (rs < 0 && bits[r]) rs = r, ts = __ffs(bits[r]) - 1;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r == rs) bits[r] &= bits[r] - 1u;
      if (!__any_sync(FULL, rs >= 0)) break;
      bool pass = false;
      uint2 e = make_uint2(0u, 0u);
      if (rs >= 0) {
        const int kl = rs * THREADS + 32 * warp + ts;
        const float2 p = sm.kp_uv[kl];
        const float du = __fsub_rn(mu, p.x);
        const float dv = __fsub_rn(mv, p.y);
        const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
        const unsigned near = d2 <= g.r_sq;
        const unsigned near_rq = recent && d2 <= g.rq_sq;
        pass = near | near_rq;
        e = make_uint2(h.x | near << 30 | near_rq << 31,
                       (unsigned)kl | (h.y & 0xffffu) << 16);
      }
      const unsigned pm = __ballot_sync(FULL, pass);
      if (cn + __popc(pm) > CQ) {
        score(cand, cn, kp0, sm.best, desc, kp_desc, g);
        cn = 0;
      }
      if (pass) cand[cn + __popc(pm & below)] = e;
      cn += __popc(pm);
    }
  }
  score(cand, cn, kp0, sm.best, desc, kp_desc, g);
}

// The end of a keypoint tile for this warp: drain its queue, then each
// keypoint that found something goes to the output by one atomicMin.
__device__ __forceinline__ void close_tile(Smem& sm, int qn, int kp0,
                                           const uint4* desc,
                                           const uint4* kp_desc,
                                           const Gates& g, int32_t* out_key) {
  drain(sm, qn, kp0, desc, kp_desc, g);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kl = r * THREADS + threadIdx.x;
    if (sm.best[kl] < NO_KEY) atomicMin(out_key + kp0 + kl, sm.best[kl]);
    sm.best[kl] = NO_KEY;
  }
}

// The work item of linear position pos in (tile x size): its tile, the
// aligned chunk c0 it lies in, and rows [lo, hi) of it up to the block's end.
struct Segment {
  int tile, c0, lo, hi;
};

__device__ __forceinline__ Segment segment(long long pos, long long end,
                                           int size) {
  Segment s;
  s.tile = (int)(pos / size);
  s.lo = (int)(pos % size);
  s.c0 = s.lo - s.lo % CH;
  s.hi = (int)min((long long)min(s.c0 + CH, size), s.lo + (end - pos));
  return s;
}

__global__ void __launch_bounds__(THREADS)
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
  __shared__ Smem sm;
  const int size = max(0, min(*size_ptr, C));
  const int frame = max_age > 0 ? *frame_ptr : 0;
  // equal ranges of the (keypoint tile x map row) pairs, point-granular
  const long long total = (long long)size * ((N + TILE - 1) / TILE);
  const long long begin = total * blockIdx.x / gridDim.x;
  const long long end = total * (blockIdx.x + 1) / gridDim.x;
  if (begin >= end) return;

  const Gates g{r_sq, max_age > 0 ? rq_sq : -1.f, hmax, rq_hmax, K};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int qn = 0;                                   // warp-uniform
  int tile = -1;
  float px[R], py[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sm.best[r * THREADS + threadIdx.x] = NO_KEY;

  long long pos = begin;
  Segment seg = segment(pos, end, size);
  stage(sm, seg.c0, C, muv, vis, last_seen, dcount);
  while (true) {
    if (seg.tile != tile) {                     // block-uniform
      if (tile >= 0) {
        close_tile(sm, qn, tile * TILE, desc, kp_desc, g, out_key);
        qn = 0;
      }
      tile = seg.tile;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int kl = r * THREADS + threadIdx.x;
        const int k = tile * TILE + kl;
        float2 p = make_float2(__int_as_float(0x7fc00000),
                               __int_as_float(0x7fc00000));
        if (k < N && kp_free[k]) p = kp_uv[k];
        px[r] = p.x;
        py[r] = p.y;
        sm.kp_uv[kl] = p;
      }
      __syncwarp();
    }

    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();            // the chunk has landed; the last sweep is over
    {
      const int i = threadIdx.x, row = seg.c0 + i;
      float rb = -1.f;
      int info = 0;
      if (row < size && sm.vis[i]) {
        bool recent = false;
        if (max_age > 0) {
          const int age = frame - sm.last[i];
          recent = age >= 1 && age <= max_age;
        }
        // a box that holds the union of the point's pixel gates: if
        // du^2 + dv^2 <= gate (rounded as in the sweep) then |du|, |dv|
        // <= sqrt(gate) (1 + 2^-23), well inside the 2^-10 margin
        rb = sqrtf(recent ? fmaxf(r_sq, rq_sq) : r_sq) * (1.f + 0x1p-10f);
        info = max(0, min(sm.dcount[i], K)) | (recent ? 1 << 16 : 0);
      }
      const float2 m = sm.muv[i];
      sm.rec[i] = make_float4(m.x, m.y, rb, __int_as_float(info));
    }
    __syncthreads();            // records ready; the raw arrays are free
    const Segment cur = seg;
    pos += cur.hi - cur.lo;
    const bool more = pos < end;
    if (more) {
      seg = segment(pos, end, size);
      stage(sm, seg.c0, C, muv, vis, last_seen, dcount);
    }

    // box sweep: 4 instructions per pair; a warp queues a point (one entry,
    // one lane writes it) when any of its keypoints falls inside the box
#pragma unroll 4
    for (int i = cur.lo - cur.c0; i < cur.hi - cur.c0; ++i) {
      const float4 m = sm.rec[i];
      float reach[R];             // max(|du|, |dv|): NaN only if both are
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        reach[r] = fmaxf(fabsf(__fsub_rn(m.x, px[r])),
                         fabsf(__fsub_rn(m.y, py[r])));
        any |= reach[r] <= m.z;
      }
      if (!__any_sync(FULL, any)) continue;
      if (qn == QE) {
        drain(sm, qn, tile * TILE, desc, kp_desc, g);
        qn = 0;
      }
      unsigned mask[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        mask[r] = __ballot_sync(FULL, reach[r] <= m.z);
      if (lane == 0) {
        sm.head[warp][qn] = make_uint4(cur.c0 + i, __float_as_uint(m.w),
                                       __float_as_uint(m.x),
                                       __float_as_uint(m.y));
#pragma unroll
        for (int w = 0; w < R / 4; ++w)
          sm.hits[warp][qn][w] = make_uint4(mask[4 * w], mask[4 * w + 1],
                                            mask[4 * w + 2], mask[4 * w + 3]);
      }
      ++qn;
    }
    if (!more) break;
  }
  close_tile(sm, qn, tile * TILE, desc, kp_desc, g, out_key);
}

// The persistent grid on the current device: as many blocks as its SMs hold
// at once. Queried once per device; later launches make one cudaGetDevice.
constexpr int MAX_DEVICES = 64;

cudaError_t grid_blocks(int* blocks) {
  static int cached[MAX_DEVICES] = {};   // same value from every writer
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, associate_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * max(per_sm, 1);
  if (dev < MAX_DEVICES) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// The work split on the current device, for tests that must overflow the
// queues: out = {blocks, keypoints per tile, queued map points per warp,
// candidate pairs per warp, keypoints per warp}.
extern "C" int vslam_associate_geometry(int* out) {
  int blocks = 0;
  const cudaError_t err = grid_blocks(&blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks, out[1] = TILE, out[2] = QE, out[3] = CQ, out[4] = 32 * R;
  return 0;
}

extern "C" int vslam_associate(const void* muv, const void* vis,
                               const void* last_seen, const void* dcount,
                               const void* desc, const void* size,
                               const void* frame, const void* kp_uv,
                               const void* kp_free, const void* kp_desc,
                               void* out_key, int C, int N, int K, float r_sq,
                               int hmax, float rq_sq, int rq_hmax,
                               int max_age, void* stream) {
  if (C > 0 && N > 0) {
    int blocks = 0;
    const cudaError_t err = grid_blocks(&blocks);
    if (err != cudaSuccess) return (int)err;
    associate_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
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
