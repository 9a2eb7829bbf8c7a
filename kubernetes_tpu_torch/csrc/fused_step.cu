// The fused per-pod commit step, scanned over a pod batch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kubernetes_tpu/ops/pallas_step.py:_step_kernel
// (called through fused_step, :162), which lax.scan runs once per pod in
// kubernetes_tpu/backend/batch.py:schedule_batch_core. Here one launch covers
// the whole batch: the per-pod winner depends on the previous pod's commit,
// so the pods run in order inside one thread block, the counterpart of the
// scan over pallas_call.
//
// For each pod p, against every node n:
//   fit      = all_r (req[p,r] == 0 || req[p,r] <= alloc[n,r] - requested[n,r])
//   ports_ok = no bit shared by ports[n,:] and the pod's wanted-port bits
//   feasible = static_ok[p,n] && fit && ports_ok
//   total    = w0*LeastAllocated + w1*BalancedAllocation + w2*norm(taint, rev)
//              + w3*norm(affinity) + w4*image           (left to right)
//   eff      = feasible ? total + jitter + (n == nominated ? 1e7 : 0) : -2^30
//   winner   = first index of the maximum eff; committed when any node is
//              feasible and the pod is valid.
// Floats follow the JAX (XLA) evaluation order with IEEE rounding: the build
// passes -fmad=false and every operation below is an explicit _rn intrinsic,
// so no multiply-add is contracted and the outputs match the plain PyTorch
// version (ops/fused_step.py:fused_step_batch_ref) bit for bit.
//
// Layout: the port's NodeTensors layout, untransposed: alloc/requested/
// nonzero [N, R] int32, ports [N, W] uint32; pod rows [P, R] / [P, W];
// [P, N] static_ok (uint8), static_ff (int8) and float32 taint/affinity/
// image/jitter; [P] nominated (int32) and p_valid (uint8). Outputs: node_idx,
// best, any_feasible [P]; fit_ok, ports_ok, first_fail [P, N]; and the three
// carries, updated in place (the wrapper passes clones).
//
// What bounds it: one block of 1024 threads on one SM runs P dependent steps,
// each a pass over N nodes, two block reductions (feasible-set maxima, then
// the argmax) and the commit. The bytes it must move (about 15 MB per batch at
// N=5120, P=128) would take a few microseconds at the card's 3.35 TB/s; this
// design is bound instead by one SM's latency per step: L2 round trips and
// barriers. Its node state stays in L2/L1 between pods. Later designs, for a
// later change:
//   * thread-block clusters with distributed shared memory: up to 16 blocks
//     of one cluster keep the node state in their shared memory and meet at
//     cluster barriers for the two reductions and the commit;
//   * a grid-wide reduction that spreads N over all SMs (a cooperative or
//     persistent kernel with a grid barrier per reduction).
// Argmax ties keep the smallest index: each thread visits its nodes in
// ascending order and keeps the first maximum, and the block reduction
// orders (value, index) pairs by value, then by the smaller index.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the block reductions read one entry per lane");
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1073741824.0f;  // -(2**30): padded nodes never win
constexpr float kNominated = 1e7f;

struct Weights {
  float fit, balanced, taint, affinity, image;
};

// int32 arithmetic that wraps like XLA's, without signed-overflow UB
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// LeastAllocated per column: floor((cap - r) * 100 / max(cap, 1)); 0 when
// cap == 0 or r > cap
__device__ __forceinline__ float least_col(float cap, float r) {
  if (cap == 0.0f || r > cap) return 0.0f;
  return floorf(__fdiv_rn(__fmul_rn(__fsub_rn(cap, r), 100.0f), fmaxf(cap, 1.0f)));
}

// BalancedAllocation's requested fraction: min(1, r / max(cap, 1)); 1 when cap == 0
__device__ __forceinline__ float frac_col(float cap, float r) {
  if (cap == 0.0f) return 1.0f;
  return fminf(1.0f, __fdiv_rn(r, fmaxf(cap, 1.0f)));
}

// DefaultNormalizeScore of one raw score given the feasible-set maximum
__device__ __forceinline__ float normalize(float raw, float mx, bool reverse) {
  const float scaled = floorf(__fdiv_rn(__fmul_rn(raw, 100.0f), fmaxf(mx, 1.0f)));
  if (reverse) return mx == 0.0f ? 100.0f : __fsub_rn(100.0f, scaled);
  return mx == 0.0f ? 0.0f : scaled;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (value, index, total) argmax: larger value wins, equal values keep the
// smaller index; the butterfly leaves the result in every lane
__device__ __forceinline__ void warp_argmax(float& v, int& i, float& t) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    const float ot = __shfl_xor_sync(kFull, t, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
      t = ot;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) fused_step_batch_kernel(
    const int* __restrict__ alloc, int* requested, int* nonzero, uint32_t* ports,
    const int* __restrict__ p_req, const int* __restrict__ p_nz,
    const uint32_t* __restrict__ p_bits, const uint8_t* __restrict__ static_ok,
    const int8_t* __restrict__ static_ff, const float* __restrict__ taint,
    const float* __restrict__ aff, const float* __restrict__ img,
    const float* __restrict__ jitter, const int* __restrict__ nominated,
    const uint8_t* __restrict__ p_valid, Weights w, int* __restrict__ node_idx,
    float* __restrict__ best, uint8_t* __restrict__ any_feasible, uint8_t* fit_ok,
    uint8_t* ports_ok, int8_t* __restrict__ first_fail, int P, int N, int R, int W) {
  // the current pod's row: R requests, R nonzero requests, W port words
  extern __shared__ int s_row[];
  int* s_req = s_row;
  int* s_nz = s_row + R;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_row + 2 * R);
  __shared__ float s_tmax[kWarps], s_amax[kWarps], s_eff[kWarps], s_tot[kWarps];
  __shared__ int s_any[kWarps], s_idx[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int p = 0; p < P; ++p) {
    if (tid < R) {
      s_req[tid] = p_req[p * R + tid];
      s_nz[tid] = p_nz[p * R + tid];
    }
    if (tid < W) s_bits[tid] = p_bits[p * W + tid];
    __syncthreads();
    bool wants_ports = false;  // no wanted port: no conflict is possible
    for (int k = 0; k < W; ++k) wants_ports |= s_bits[k] != 0u;
    const size_t row = static_cast<size_t>(p) * N;

    // ---- pass 1: feasibility, first-fail ids, feasible-set maxima
    float tmax = -INFINITY, amax = -INFINITY;
    int anyf = 0;
    for (int n = tid; n < N; n += kThreads) {
      const int* a = alloc + static_cast<size_t>(n) * R;
      const int* rq = requested + static_cast<size_t>(n) * R;
      bool fit = true;
      for (int r = 0; r < R; ++r) {
        const int pr = s_req[r];
        fit = fit && (pr == 0 || pr <= wrap_sub(a[r], rq[r]));
      }
      bool pok = true;
      if (wants_ports) {
        const uint32_t* pw = ports + static_cast<size_t>(n) * W;
        for (int k = 0; k < W; ++k) pok = pok && (pw[k] & s_bits[k]) == 0u;
      }
      const bool feas = static_ok[row + n] && fit && pok;
      fit_ok[row + n] = fit;
      ports_ok[row + n] = pok;
      int8_t ff = static_ff[row + n];
      if (ff == 0 && !pok) ff = 5;
      if (ff == 0 && !fit) ff = 6;
      first_fail[row + n] = ff;
      tmax = fmaxf(tmax, feas ? taint[row + n] : 0.0f);
      amax = fmaxf(amax, feas ? aff[row + n] : 0.0f);
      anyf |= feas;
    }
    tmax = warp_max(tmax);
    amax = warp_max(amax);
    anyf = __any_sync(kFull, anyf);
    if (lane == 0) {
      s_tmax[warp] = tmax;
      s_amax[warp] = amax;
      s_any[warp] = anyf;
    }
    __syncthreads();
    tmax = warp_max(s_tmax[lane]);
    amax = warp_max(s_amax[lane]);
    anyf = __any_sync(kFull, s_any[lane]);

    // ---- pass 2: scores and the jittered masked argmax
    const int nom = nominated[p];
    const int pnz0 = s_nz[0], pnz1 = s_nz[1];
    float bv = -INFINITY, bt = 0.0f;
    int bi = 0x7fffffff;
    for (int n = tid; n < N; n += kThreads) {
      const bool feas = static_ok[row + n] && fit_ok[row + n] && ports_ok[row + n];
      const int* a = alloc + static_cast<size_t>(n) * R;
      const int* z = nonzero + static_cast<size_t>(n) * R;
      const float cap0 = static_cast<float>(a[0]);
      const float cap1 = static_cast<float>(a[1]);
      const float r0 = static_cast<float>(wrap_add(z[0], pnz0));
      const float r1 = static_cast<float>(wrap_add(z[1], pnz1));
      const float least = floorf(__fdiv_rn(__fadd_rn(least_col(cap0, r0), least_col(cap1, r1)), 2.0f));
      const float diff = fabsf(__fsub_rn(frac_col(cap0, r0), frac_col(cap1, r1)));
      const float balanced = floorf(__fmul_rn(__fsub_rn(1.0f, __fdiv_rn(diff, 2.0f)), 100.0f));
      float total = __fmul_rn(w.fit, least);
      total = __fadd_rn(total, __fmul_rn(w.balanced, balanced));
      total = __fadd_rn(total, __fmul_rn(w.taint, normalize(taint[row + n], tmax, true)));
      total = __fadd_rn(total, __fmul_rn(w.affinity, normalize(aff[row + n], amax, false)));
      total = __fadd_rn(total, __fmul_rn(w.image, img[row + n]));
      const float eff =
          feas ? __fadd_rn(__fadd_rn(total, jitter[row + n]), n == nom ? kNominated : 0.0f)
               : kNegInf;
      if (eff > bv) {  // ascending n: the first maximum of this thread stays
        bv = eff;
        bi = n;
        bt = total;
      }
    }
    warp_argmax(bv, bi, bt);
    if (lane == 0) {
      s_eff[warp] = bv;
      s_idx[warp] = bi;
      s_tot[warp] = bt;
    }
    __syncthreads();
    bv = s_eff[lane];
    bi = s_idx[lane];
    bt = s_tot[lane];
    warp_argmax(bv, bi, bt);

    // ---- commit the winner's R + W entries
    const bool commit = anyf && p_valid[p] != 0;
    if (tid == 0) {
      node_idx[p] = commit ? bi : -1;
      best[p] = bt;
      any_feasible[p] = commit;
    }
    if (commit) {
      if (tid < R) {
        const size_t at = static_cast<size_t>(bi) * R + tid;
        requested[at] = wrap_add(requested[at], s_req[tid]);
        nonzero[at] = wrap_add(nonzero[at], s_nz[tid]);
      } else if (tid < R + W) {
        ports[static_cast<size_t>(bi) * W + (tid - R)] |= s_bits[tid - R];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ktpu_fused_step_batch(
    const void* alloc, void* requested, void* nonzero, void* ports, const void* p_req,
    const void* p_nz, const void* p_bits, const void* static_ok, const void* static_ff,
    const void* taint, const void* aff, const void* img, const void* jitter,
    const void* nominated, const void* p_valid, float w_fit, float w_balanced,
    float w_taint, float w_affinity, float w_image, void* node_idx, void* best,
    void* any_feasible, void* fit_ok, void* ports_ok, void* first_fail, int P, int N,
    int R, int W, void* stream) {
  const Weights w{w_fit, w_balanced, w_taint, w_affinity, w_image};
  const size_t smem = static_cast<size_t>(2 * R + W) * sizeof(int);
  fused_step_batch_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(alloc), static_cast<int*>(requested),
      static_cast<int*>(nonzero), static_cast<uint32_t*>(ports),
      static_cast<const int*>(p_req), static_cast<const int*>(p_nz),
      static_cast<const uint32_t*>(p_bits), static_cast<const uint8_t*>(static_ok),
      static_cast<const int8_t*>(static_ff), static_cast<const float*>(taint),
      static_cast<const float*>(aff), static_cast<const float*>(img),
      static_cast<const float*>(jitter), static_cast<const int*>(nominated),
      static_cast<const uint8_t*>(p_valid), w, static_cast<int*>(node_idx),
      static_cast<float*>(best), static_cast<uint8_t*>(any_feasible),
      static_cast<uint8_t*>(fit_ok), static_cast<uint8_t*>(ports_ok),
      static_cast<int8_t*>(first_fail), P, N, R, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ktpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
