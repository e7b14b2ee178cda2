// RANSAC's Gauss-Newton polish (geometry/epipolar.py refine_pose_gn): one
// LM iteration's linearisation, and the robust cost of a trial step, each
// for every start in one launch.
//
// It replaces no Pallas kernel: the JAX package's polish is jnp under jit,
// which XLA fuses. In the port the loop body was ~1,200 ATen kernels an
// iteration (five forward-mode JVPs through _sampson_res, their stacks and
// the normal equations), about 12,400 of the tracking step's ~16,800
// kernels. The iteration's decisions (the damped 5x5 solve, lambda's
// schedule, the accept test, the retraction, the multistart's fan and
// choice) stay in torch; each entry here is a pure function of its inputs,
// with ops/sampson_gn.py's plain versions as its oracle.
//
// What the entries compute, in f32 (accumulators too):
// * linearize: for start s at (R_s, t_s), the signed Sampson residuals r_n
//   of _sampson_res at zero in its 5 tangent parameters and their exact
//   first derivatives J_n, by forward-mode dual arithmetic through
//   _sampson_res's operations in their order (so3_exp's Taylor branch at
//   zero, _t_basis's axis choice, the normalisation with its +1e-12,
//   E = hat(t) R, Ex1, E^T x2, num, den, the clamp at 1e-18, the sqrt),
//   each derivative by the rule torch's forward AD applies to that
//   operation; Cauchy weights rw_n = valid_n / (1 + q_n^2), q = r / c; then
//   H = sum_n (J_n rw_n)^T J_n (15 sums, written to both triangles),
//   g = sum_n J_n rw_n r_n and cost = sum_n valid_n c^2/2 log1p(q_n^2).
// * trial_cost: that cost of _sampson_res at delta_s.
// Masking multiplies, as the torch form does: a NaN residual of a match
// with valid 0 still makes its start's H, g and cost NaN.
//
// Bound: about 350 f32 operations a (start, match) pair for linearize and
// 50 for trial_cost; a default step's polish, 13 starts x 3072 matches x
// (10 linearisations + 11 trial costs), is ~160 M operations, 2.4 us at
// 67 TFLOP/s, and reads ~90 KB a launch. Neither bounds it: each launch is
// ~40k pairs on 13 blocks, so it is bound by latency (one block's walk
// over N and its reduction): on an H100 at 700 W a linearisation takes
// ~17 us and a trial cost ~9 us at the step's shape.
//
// Design: one block a start. Lanes 0-5 of the first warp build E and its
// 5 tangents (54 floats) once in shared memory; each thread then walks the
// matches with stride blockDim, keeping its 21 sums (1 for trial_cost) in
// registers. The sums are reduced in a fixed order: warp butterflies of
// shuffles, then the warps' partials from shared memory, summed in warp
// order by one thread a sum. No atomics, so two launches on the same
// inputs give the same bits. The block size follows N: a warp per 128
// matches (4 a thread), from 32 to 512 threads.
#include <cuda_runtime.h>

#include <cmath>

namespace {

// ---- the arithmetic of _sampson_res and its tangents (host and device) ----

#define HD __host__ __device__ __forceinline__

// C = A @ B, 3x3 row-major, each entry the sum of its 3 products in order
HD void mat3_mul(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = A[i * 3] * B[j] + A[i * 3 + 1] * B[3 + j] +
                     A[i * 3 + 2] * B[6 + j];
}

// lie.hat: (3,) -> (3, 3) skew-symmetric
HD void hat(const float* v, float* W) {
  W[0] = 0.0f, W[1] = -v[2], W[2] = v[1];
  W[3] = v[2], W[4] = 0.0f, W[5] = -v[0];
  W[6] = -v[1], W[7] = v[0], W[8] = 0.0f;
}

// torch.linalg.cross
HD void cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// lie.so3_exp: Rodrigues with its small-angle Taylor branch
HD void so3_exp(const float* w, float* out) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float th = sqrtf(th2 + 1e-16f);
  float W[9], W2[9];
  hat(w, W);
  mat3_mul(W, W, W2);
  const bool small = th2 < 1e-8f;
  const float A = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float B =
      small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / (th2 + 1e-8f);
  for (int i = 0; i < 9; ++i)
    out[i] = (i % 4 == 0 ? 1.0f : 0.0f) + A * W[i] + B * W2[i];
}

// so3_exp's tangent at w = 0 along dw: the Taylor branch's dual, with
// th2 = 0 and dth2 = dw.w + w.dw = 0, so A = 1, B = 1/2, dA = dB = 0,
// W = W2 = 0 and dW2 = dW W + W dW = 0:  dA W + A dW + dB W2 + B dW2
HD void so3_exp_tangent_at_zero(const float* dw, float* out) {
  const float w[3] = {0.0f, 0.0f, 0.0f};
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float dth2 = (dw[0] * w[0] + dw[0] * w[0]) +
                     (dw[1] * w[1] + dw[1] * w[1]) +
                     (dw[2] * w[2] + dw[2] * w[2]);
  const float A = 1.0f - th2 / 6.0f, dA = -(dth2 / 6.0f);
  const float B = 0.5f - th2 / 24.0f, dB = -(dth2 / 24.0f);
  float W[9], dW[9], W2[9], dW2[9], P[9], Q[9];
  hat(w, W);
  hat(dw, dW);
  mat3_mul(W, W, W2);
  mat3_mul(dW, W, P);
  mat3_mul(W, dW, Q);
  for (int i = 0; i < 9; ++i) dW2[i] = P[i] + Q[i];
  for (int i = 0; i < 9; ++i)
    out[i] = (dW[i] * A + dA * W[i]) + (dW2[i] * B + dB * W2[i]);
}

// _t_basis: the plane orthogonal to unit t, from the axis of least |t_i|
// (the first of ties; a NaN is least, as torch.argmin takes it)
HD void t_basis(const float* t, float* b1, float* b2) {
  int ax = 0;
  float m = fabsf(t[0]);
  for (int i = 1; i < 3; ++i) {
    const float a = fabsf(t[i]);
    if (a < m || (a != a && m == m)) ax = i, m = a;
  }
  const float e[3] = {ax == 0 ? 1.0f : 0.0f, ax == 1 ? 1.0f : 0.0f,
                      ax == 2 ? 1.0f : 0.0f};
  cross(t, e, b1);
  const float n = sqrtf(b1[0] * b1[0] + b1[1] * b1[1] + b1[2] * b1[2]);
  for (int i = 0; i < 3; ++i) b1[i] = b1[i] / (n + 1e-12f);
  cross(t, b1, b2);
}

// The start's pose moved by its 5 tangent parameters p (rotation, then the
// translation direction) and its tangent along dp, as _sampson_res builds
// them: Rn = R0 so3_exp(p_w), tn = t0 + B p_t normalised, E = hat(tn) Rn.
// part < 0 gives E at p; part k in 0-4 gives E's tangent along e_k at
// p = 0 (mm: dA B + A dB; div: (da - db a / b) / b as (da - db r) / b;
// vector_norm: (x . dx) / |x|, 0 where |x| is 0).
HD void start_matrix(const float* R0, const float* t0, const float* p,
                     int part, float* out) {
  float X[9], Rn[9], b1[3], b2[3], tn[3];
  so3_exp(p, X);
  mat3_mul(R0, X, Rn);
  t_basis(t0, b1, b2);
  for (int i = 0; i < 3; ++i) tn[i] = t0[i] + (b1[i] * p[3] + b2[i] * p[4]);
  const float nrm = sqrtf(tn[0] * tn[0] + tn[1] * tn[1] + tn[2] * tn[2]);
  const float d = nrm + 1e-12f;
  float tnn[3], T[9];
  for (int i = 0; i < 3; ++i) tnn[i] = tn[i] / d;
  hat(tnn, T);
  if (part < 0) {
    mat3_mul(T, Rn, out);
    return;
  }
  const float dp[5] = {part == 0 ? 1.0f : 0.0f, part == 1 ? 1.0f : 0.0f,
                       part == 2 ? 1.0f : 0.0f, part == 3 ? 1.0f : 0.0f,
                       part == 4 ? 1.0f : 0.0f};
  float dX[9], dRn[9], dtn[3], dtnn[3], dT[9], P[9], Q[9];
  so3_exp_tangent_at_zero(dp, dX);
  mat3_mul(R0, dX, dRn);
  for (int i = 0; i < 3; ++i) dtn[i] = b1[i] * dp[3] + b2[i] * dp[4];
  const float dot = (tn[0] * dtn[0] + tn[1] * dtn[1]) + tn[2] * dtn[2];
  const float dnrm = nrm == 0.0f ? 0.0f : dot / nrm;
  for (int i = 0; i < 3; ++i) dtnn[i] = (dtn[i] - dnrm * tnn[i]) / d;
  hat(dtnn, dT);
  mat3_mul(dT, Rn, P);
  mat3_mul(T, dRn, Q);
  for (int i = 0; i < 9; ++i) out[i] = P[i] + Q[i];
}

// Ex1, the first two entries of E^T x2, num and the clamped den of one
// match: the parts of _sampson_res before its division
struct Sampson {
  float a[3], b[2], num, den, s, r;
};

HD Sampson sampson(const float* E, const float* x1, const float* x2) {
  Sampson m;
  for (int i = 0; i < 3; ++i)
    m.a[i] = E[i * 3] * x1[0] + E[i * 3 + 1] * x1[1] + E[i * 3 + 2] * x1[2];
  for (int i = 0; i < 2; ++i)
    m.b[i] = E[i] * x2[0] + E[3 + i] * x2[1] + E[6 + i] * x2[2];
  m.num = x2[0] * m.a[0] + x2[1] * m.a[1] + x2[2] * m.a[2];
  m.den = m.a[0] * m.a[0] + m.a[1] * m.a[1] + m.b[0] * m.b[0] +
          m.b[1] * m.b[1];
  // clamp(den, 1e-18), which keeps a NaN
  m.s = sqrtf(m.den < 1e-18f ? 1e-18f : m.den);
  m.r = m.num / m.s;
  return m;
}

// d r along the tangent dE of E (mul: da a + a da; clamp: the tangent
// where den >= 1e-18, else 0; sqrt: dx / (2 s); div: (dnum - ds r) / s)
HD float sampson_tangent(const Sampson& m, const float* dE, const float* x1,
                         const float* x2) {
  float da[3], db[2];
  for (int i = 0; i < 3; ++i)
    da[i] = dE[i * 3] * x1[0] + dE[i * 3 + 1] * x1[1] + dE[i * 3 + 2] * x1[2];
  for (int i = 0; i < 2; ++i)
    db[i] = dE[i] * x2[0] + dE[3 + i] * x2[1] + dE[6 + i] * x2[2];
  const float dnum = x2[0] * da[0] + x2[1] * da[1] + x2[2] * da[2];
  const float dden = (da[0] * m.a[0] + da[0] * m.a[0]) +
                     (da[1] * m.a[1] + da[1] * m.a[1]) +
                     (db[0] * m.b[0] + db[0] * m.b[0]) +
                     (db[1] * m.b[1] + db[1] * m.b[1]);
  const float dcl = m.den >= 1e-18f ? dden : 0.0f;
  const float ds = dcl / (2.0f * m.s);
  return (dnum - ds * m.r) / m.s;
}

// one match's term of cost(r): valid * 0.5 * c^2 * log1p(q^2), q = r / c
HD float cost_term(float r, float valid, float c) {
  const float q = r / c;
  return valid * 0.5f * (c * c) * log1pf(q * q);
}

#undef HD

// ---- the kernels ----

constexpr int MAX_THREADS = 512;
constexpr int MATCHES_PER_THREAD = 4;
constexpr int MAX_WARPS = MAX_THREADS / 32;

int block_threads(int n) {
  const int want = (n + MATCHES_PER_THREAD - 1) / MATCHES_PER_THREAD;
  const int warps = (want + 31) / 32;
  return 32 * (warps < 1 ? 1 : warps > MAX_WARPS ? MAX_WARPS : warps);
}

// LINEARIZE: 21 sums (H's 15, g's 5, the cost); else the cost at delta
template <bool LINEARIZE>
__global__ void __launch_bounds__(MAX_THREADS)
sampson_kernel(const float* __restrict__ R, const float* __restrict__ t,
               const float* __restrict__ delta, const float* __restrict__ x1,
               const float* __restrict__ x2, const float* __restrict__ valid,
               const float* __restrict__ c_ptr, float* __restrict__ H,
               float* __restrict__ g, float* __restrict__ cost, int n) {
  constexpr int PARTS = LINEARIZE ? 6 : 1;     // E, then its 5 tangents
  constexpr int SUMS = LINEARIZE ? 21 : 1;
  __shared__ float sE[PARTS][9];
  __shared__ float red[MAX_WARPS][SUMS];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;

  if (tid < PARTS) {
    float R0[9], t0[3], p[5];
    for (int i = 0; i < 9; ++i) R0[i] = R[s * 9 + i];
    for (int i = 0; i < 3; ++i) t0[i] = t[s * 3 + i];
    for (int i = 0; i < 5; ++i) p[i] = LINEARIZE ? 0.0f : delta[s * 5 + i];
    start_matrix(R0, t0, p, tid - 1, sE[tid]);
  }
  const float c = *c_ptr;
  __syncthreads();

  float E[9];
  for (int i = 0; i < 9; ++i) E[i] = sE[0][i];
  float acc[SUMS];
  for (int k = 0; k < SUMS; ++k) acc[k] = 0.0f;

  for (int i = tid; i < n; i += blockDim.x) {
    const float p1[3] = {x1[3 * i], x1[3 * i + 1], x1[3 * i + 2]};
    const float p2[3] = {x2[3 * i], x2[3 * i + 1], x2[3 * i + 2]};
    const float v = valid[i];
    const Sampson m = sampson(E, p1, p2);
    if (LINEARIZE) {
      const float q = m.r / c;
      const float rw = v / (1.0f + q * q);
      float J[5], Jw[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        J[k] = sampson_tangent(m, sE[k + 1], p1, p2);
        Jw[k] = J[k] * rw;
      }
      int k = 0;                               // H's (a, b), a <= b
#pragma unroll
      for (int a = 0; a < 5; ++a)
#pragma unroll
        for (int b = a; b < 5; ++b) acc[k++] += Jw[a] * J[b];
#pragma unroll
      for (int k = 0; k < 5; ++k) acc[15 + k] += Jw[k] * m.r;
    }
    acc[SUMS - 1] += cost_term(m.r, v, c);
  }

  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int k = 0; k < SUMS; ++k) {
    float x = acc[k];
    for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp][k] = x;
  }
  __syncthreads();
  if (tid < SUMS) {
    float x = red[0][tid];
    for (int w = 1; w < (int)blockDim.x / 32; ++w) x += red[w][tid];
    if (tid == SUMS - 1) {
      cost[s] = x;
    } else if (tid < 15) {
      int a = 0, b = tid;                      // the sum's (a, b)
      while (b >= 5 - a) b -= 5 - a, ++a;
      b += a;
      H[s * 25 + a * 5 + b] = x;
      H[s * 25 + b * 5 + a] = x;
    } else {
      g[s * 5 + tid - 15] = x;
    }
  }
}

}  // namespace

// R (S, 3, 3), t (S, 3), x1, x2 (N, 3), valid (N,) and c () contiguous f32
// on one device; H (S, 5, 5), g (S, 5) and cost (S,) contiguous f32
// outputs. Returns cudaErrorInvalidValue for an S or N below 1.
extern "C" int vslam_sampson_linearize(const void* R, const void* t,
                                       const void* x1, const void* x2,
                                       const void* valid, const void* c,
                                       void* H, void* g, void* cost, int S,
                                       int N, void* stream) {
  if (S < 1 || N < 1) return (int)cudaErrorInvalidValue;
  sampson_kernel<true><<<S, block_threads(N), 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(R), static_cast<const float*>(t), nullptr,
      static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<const float*>(valid), static_cast<const float*>(c),
      static_cast<float*>(H), static_cast<float*>(g),
      static_cast<float*>(cost), N);
  return (int)cudaGetLastError();
}

// delta (S, 5) and the rest as vslam_sampson_linearize; cost (S,) output.
extern "C" int vslam_sampson_trial_cost(const void* delta, const void* R,
                                        const void* t, const void* x1,
                                        const void* x2, const void* valid,
                                        const void* c, void* cost, int S,
                                        int N, void* stream) {
  if (S < 1 || N < 1) return (int)cudaErrorInvalidValue;
  sampson_kernel<false><<<S, block_threads(N), 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(R), static_cast<const float*>(t),
      static_cast<const float*>(delta), static_cast<const float*>(x1),
      static_cast<const float*>(x2), static_cast<const float*>(valid),
      static_cast<const float*>(c), nullptr, nullptr,
      static_cast<float*>(cost), N);
  return (int)cudaGetLastError();
}
