// The batched cyclic Jacobi eigensolver of ops/jacobi.py in one launch.
//
// jacobi_eigh_plain(A, sweeps) runs every round of every sweep as ~50
// PyTorch kernels (_round_step), then a stable argsort and two gathers. This
// kernel runs all of it in one launch and gives the same bits on the card:
//
// * the schedule is ops/jacobi.py's round-robin schedule, packed there as a
//   (rounds, n) int8 table of partners (i's partner in the round, or i for
//   the idle index of an odd n) and read here; it is never written out in C;
// * a round computes c and s per pair from the old diagonal and A[p][q],
//   rotates the rows of the old A, then the columns of the row-rotated A,
//   zeroes the rotated (p, q) and (q, p) entries, and rotates the columns of
//   the old V, every write out of place, as _round_step does;
// * every float operation is one IEEE-rounded intrinsic in the order the
//   torch ops round them (c X and s X_partner each rounded, then added), so
//   nothing is contracted into an FMA; rsqrtf is the function PyTorch's CUDA
//   rsqrt calls;
// * eigenvalues are ordered as torch.argsort(stable=True) orders them:
//   ascending, NaN last, ties (and -0 against +0) in index order.
//
// The work is a few thousand rounds of tiny matrices, so it is bound by
// latency, not by arithmetic or bytes: 1024 9x9 at 4 sweeps is 36 rounds of
// ~750 flops a matrix, and each round waits on the last. Design: a group of
// G lanes of one warp holds one matrix, G the power of two at least n^2 (at
// most 32), each lane owning up to 3 entries; A and V, double-buffered, live
// in shared memory, and no global memory is touched between the load and
// the sorted store. A round is two steps behind two __syncwarp: lanes below
// n compute their index's (c, s); then each lane writes its entries of the
// next A and V, computing the two row-pass entries its column pass reads
// itself, so the row pass needs no barrier of its own.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;             // warps per block
constexpr int MAX_N = 9;
constexpr int MAX_ROUNDS = MAX_N;    // m - 1 rounds, m = n rounded up to even

__host__ __device__ constexpr int group_lanes(int nn) {
  return nn > 16 ? 32 : nn > 8 ? 16 : nn > 4 ? 8 : 4;
}

// ascending, NaN after every number (the order torch's sort gives)
__device__ __forceinline__ bool before(float x, float y) {
  return (isnan(y) && !isnan(x)) || x < y;
}

// c X + s Y with each product rounded, as mul, mul, add round them
__device__ __forceinline__ float rot(float c, float x, float s, float y) {
  return __fadd_rn(__fmul_rn(c, x), __fmul_rn(s, y));
}

template <int N>
__global__ void __launch_bounds__(WARPS * 32)
jacobi_kernel(const float* __restrict__ a, long long s0, long long s1,
              long long s2, const int8_t* __restrict__ table, int rounds,
              int sweeps, float* __restrict__ evals, float* __restrict__ vecs,
              long long batch) {
  constexpr int NN = N * N;
  constexpr int G = group_lanes(NN);           // lanes per matrix
  constexpr int E = (NN + G - 1) / G;          // entries per lane
  constexpr int M = WARPS * (32 / G);          // matrices per block
  static_assert(G >= N, "a lane per index computes the coefficients");
  __shared__ float sA[2][M][NN], sV[2][M][NN];
  __shared__ float sc[M][N], ss[M][N];
  __shared__ int sord[M][N];
  __shared__ int8_t part[MAX_ROUNDS][N];

  for (int k = threadIdx.x; k < rounds * N; k += blockDim.x)
    part[k / N][k % N] = table[k];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int slot = threadIdx.x / G;            // the matrix's slot in the block
  const int g = lane % G;                      // the lane within its group
  const long long b = (long long)blockIdx.x * M + slot;
  const bool live = b < batch;
  float* A = sA[0][slot];                      // this round's A and V
  float* V = sV[0][slot];
  float* A2 = sA[1][slot];                     // the next round's
  float* V2 = sV[1][slot];
  float* C = sc[slot];
  float* S = ss[slot];

#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = g + k * G;
    if (e < NN) {
      const int i = e / N, j = e % N;
      A[e] = live ? a[b * s0 + i * s1 + j * s2] : 0.0f;
      V[e] = i == j ? 1.0f : 0.0f;
    }
  }
  __syncwarp();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < rounds; ++r) {
      const int8_t* P = part[r];
      int pi[E], pj[E];                        // partners of row and column
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int e = min(g + k * G, NN - 1);
        pi[k] = P[e / N];
        pj[k] = P[e % N];
      }
      if (g < N && P[g] != g) {                // index g's pair, (p, q)
        const int p = min(g, (int)P[g]), q = max(g, (int)P[g]);
        const float app = A[p * N + p], aqq = A[q * N + q];
        const float apq = A[p * N + q];
        const bool tiny = fabsf(apq) < 1e-30f;
        const float safe = tiny ? 1e-30f : __fmul_rn(2.0f, apq);
        const float tau = __fdiv_rn(__fsub_rn(aqq, app), safe);
        const float sgn = (float)((0.0f < tau) - (tau < 0.0f));
        const float den = __fadd_rn(
            fabsf(tau), __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau))));
        float t = __fdiv_rn(-sgn, den);
        if (tau == 0.0f) t = 1.0f;
        float c = rsqrtf(__fadd_rn(1.0f, __fmul_rn(t, t)));
        float s = __fmul_rn(t, c);
        if (tiny) c = 1.0f, s = 0.0f;
        C[g] = c;
        S[g] = __fmul_rn(s, g == p ? 1.0f : -1.0f);
      }
      __syncwarp();
      // Entry (i, j) of the round's A: the column pass at (i, j) of the
      // row pass, whose entries (i, j) and (i, pj) the lane computes itself
      // from the old A, as the row pass rounds them; the round's pairs
      // zeroed. V's columns from the old V.
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int e = g + k * G;
        if (e < NN) {
          const int i = e / N, j = e % N;
          const float* Ai = A + i * N;
          const float* Ap = A + pi[k] * N;
          const bool row = pi[k] != i;
          const float bij = row ? rot(C[i], Ai[j], S[i], Ap[j]) : Ai[j];
          float x = bij;
          if (pj[k] != j) {
            const float biq =
                row ? rot(C[i], Ai[pj[k]], S[i], Ap[pj[k]]) : Ai[pj[k]];
            x = rot(C[j], bij, S[j], biq);
          }
          A2[e] = pi[k] == j && i != j ? 0.0f : x;
          V2[e] = pj[k] != j ? rot(C[j], V[e], S[j], V[i * N + pj[k]]) : V[e];
        }
      }
      float* const a_old = A;
      A = A2;
      A2 = a_old;
      float* const v_old = V;
      V = V2;
      V2 = v_old;
      __syncwarp();
    }
  }

  // stable rank of each diagonal entry: those before it, and its ties with
  // a lower index
  if (g < N) {
    const float d = A[g * N + g];
    int rank = 0;
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const float x = A[m * N + m];
      rank += before(x, d) || (m < g && !before(d, x));
    }
    sord[slot][rank] = g;
  }
  __syncwarp();
  if (live) {
    const int* ord = sord[slot];
    if (g < N) evals[b * N + g] = A[ord[g] * (N + 1)];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = g + k * G;
      if (e < NN) vecs[b * NN + e] = V[e - e % N + ord[e % N]];
    }
  }
}

template <int N>
cudaError_t launch(const float* a, long long s0, long long s1, long long s2,
                   const int8_t* table, int rounds, int sweeps, float* evals,
                   float* vecs, long long batch, cudaStream_t stream) {
  constexpr int M = WARPS * (32 / group_lanes(N * N));
  const long long blocks = (batch + M - 1) / M;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  jacobi_kernel<N><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      a, s0, s1, s2, table, rounds, sweeps, evals, vecs, batch);
  return cudaGetLastError();
}

}  // namespace

// a: (batch, n, n) f32 read at strides (s0, s1, s2) elements; table: the
// (rounds, n) int8 partners of ops/jacobi.py; evals (batch, n) and vecs
// (batch, n, n) contiguous f32 outputs. Returns cudaErrorInvalidValue for an
// n, a table or a batch outside the kernel's scope.
extern "C" int vslam_jacobi(const void* a, long long s0, long long s1,
                            long long s2, const void* table, int n,
                            int rounds, int sweeps, void* evals, void* vecs,
                            long long batch, void* stream) {
  if (n < 2 || n > MAX_N || rounds < 1 || rounds > MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaGetLastError();
  using Launch = cudaError_t (*)(const float*, long long, long long,
                                 long long, const int8_t*, int, int, float*,
                                 float*, long long, cudaStream_t);
  static const Launch by_n[MAX_N - 1] = {launch<2>, launch<3>, launch<4>,
                                         launch<5>, launch<6>, launch<7>,
                                         launch<8>, launch<9>};
  return (int)by_n[n - 2](static_cast<const float*>(a), s0, s1, s2,
                          static_cast<const int8_t*>(table), rounds, sweeps,
                          static_cast<float*>(evals),
                          static_cast<float*>(vecs), batch,
                          (cudaStream_t)stream);
}
