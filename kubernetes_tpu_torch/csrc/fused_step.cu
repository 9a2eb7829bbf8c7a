// The fused per-pod commit step, scanned over a pod batch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kubernetes_tpu/ops/pallas_step.py:_step_kernel
// (called through fused_step, :162), which lax.scan runs once per pod in
// kubernetes_tpu/backend/batch.py:schedule_batch_core. Here one launch covers
// the whole batch: the per-pod winner depends on the previous pod's commit,
// so the pods run in order inside one thread-block cluster, the counterpart
// of the scan over pallas_call.
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
// Design: one cluster of kCluster = 8 blocks of 1024 threads, on 8 SMs of one
// GPC, splits the node axis. Block `rank` owns the slots [rank*M, (rank+1)*M)
// clipped to N, with M = ceil(N / 8), and only that block reads or writes
// those rows of the carries (in device memory) and those columns of the
// [P, N] outputs. Inside a block, warp 0 leads and owns no node; each thread
// of warps 1-31 owns the nodes n0, n0 + 992, ... of the slice (one node for
// N <= 7936) and is the only thread that reads their carry rows. Nothing but
// two reductions crosses blocks. Per pod:
//   1. pass 1 over the slice: fit, ports, first-fail ids and the block's
//      partial (taint maximum, affinity maximum, any feasible), which warp 0
//      stores into its slot in every block's shared memory; cluster barrier;
//      every block combines the 8 partials. Max and any do not depend on
//      order, so every block gets the same bits;
//   2. pass 2 over the slice: scores and the block's (eff, index, total)
//      argmax into its slot of a second array; cluster barrier; every warp
//      reduces the 8 candidates by the same rule, so all agree on the winner;
//   3. rank 0 writes the pod's outputs, and the warp of the winner's owner
//      thread commits its R + W entries; the owner sees them after
//      __syncwarp(), so no block barrier ends the pod.
// Meanwhile warp 0 copies the next pod's request row into shared memory, and
// each thread loads its first node's six [P, N] values for the next pod while
// barrier 2 completes, keeping them (and its feasibility and resource score)
// in registers from pass 1 to pass 2. A block whose slice is empty (N < 8, or
// a short last slice) offers the neutral partial and candidate and still
// meets every barrier.
//
// What bounds it: the per-pod chain, not bytes. The bytes it must move (about
// 15 MB per batch at N=5120, P=128) would take a few microseconds at the
// card's 3.35 TB/s. Each of the P dependent steps instead runs two passes
// whose arithmetic and L1/L2 loads of the node state share one SM's
// instruction slots per 640 nodes, two block reductions, and two cluster
// barriers, each behind warp 0's release of its remote stores. Later
// designs, for a later change:
//   * the block's slice of the node state held in shared memory;
//   * prefetching every node's [P, N] values for pod p+1, not only the
//     first, while pod p reduces;
//   * the exchange of partials and candidates through st.async and an
//     mbarrier per block, in place of the cluster barrier and its release;
//   * a 16-block cluster (non-portable, launched with cudaLaunchKernelEx);
//   * a grid-wide design that spreads N over all SMs, with a grid barrier
//     per reduction.
// Argmax ties keep the smallest index: each thread visits its nodes in
// ascending order and keeps the first maximum, and every reduction (warp,
// block, cluster) orders (value, index) pairs by value, then by the smaller
// index. Slices are contiguous and ascending, so the cluster's winner is the
// first maximum over all N.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // the portable cluster size: no launch attribute needed
constexpr int kThreads = 1024;
constexpr int kNodeThreads = kThreads - 32;  // warp 0 owns no node
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the block reductions read one entry per lane");
static_assert(kCluster == 8, "the cluster reductions are three butterfly rounds");
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1073741824.0f;  // -(2**30): padded nodes never win
constexpr float kNominated = 1e7f;

struct Weights {
  float fit, balanced, taint, affinity, image;
};

// Phase stamps for kubernetes_tpu_torch/perf/kernel_phases.py. Built with
// -DKTPU_PHASE_STAMPS, thread 32 (the first thread of warp 1, which owns a
// node) of each block records clock64() at kStamps points of each of the
// first kStampPods pods; otherwise PHASE_STAMP compiles to nothing.
#ifdef KTPU_PHASE_STAMPS
constexpr int kStamps = 12;
constexpr int kStampPods = 4096;
__device__ long long g_stamps[kCluster * kStampPods * kStamps];
#define PHASE_STAMP(k)                                                             \
  if (threadIdx.x == 32 && p < kStampPods)                                         \
  g_stamps[(static_cast<size_t>(blockIdx.x) * kStampPods + p) * kStamps + (k)] = \
      clock64()
#else
#define PHASE_STAMP(k)
#endif

// A block's feasible-set partial: the raw taint and affinity maxima and
// whether any of its nodes is feasible. 16 bytes: one remote store.
struct alignas(16) Partial {
  float tmax, amax;
  int any, pad;
};

// A block's argmax candidate: (eff, node index, total without jitter).
struct alignas(16) Candidate {
  float eff;
  int idx;
  float tot;
  int pad;
};

// One pod's [P, N] inputs at one node
struct NodeRow {
  bool ok;
  int8_t ff;
  float taint, aff, img, jitter;
};

struct Rows {
  const uint8_t* ok;
  const int8_t* ff;
  const float *taint, *aff, *img, *jitter;

  // read-only for the whole launch: the non-coherent path
  __device__ __forceinline__ NodeRow at(size_t i) const {
    return NodeRow{__ldg(ok + i) != 0, __ldg(ff + i), __ldg(taint + i),
                   __ldg(aff + i),     __ldg(img + i), __ldg(jitter + i)};
  }
};

// One warp copies pod q's request row into a shared row laid out as R
// requests, R nonzero requests and W port words, and notes whether the pod
// wants any host port (none: no conflict is possible, and the [N, W] scan is
// skipped)
__device__ __forceinline__ void load_pod_row(const int* p_req, const int* p_nz,
                                             const uint32_t* p_bits, int q, int R, int W,
                                             int* s_row, int* s_wants, int lane) {
  for (int k = lane; k < R; k += 32) {
    s_row[k] = p_req[q * R + k];
    s_row[R + k] = p_nz[q * R + k];
  }
  bool wants = false;
  for (int k = lane; k < W; k += 32) {
    const uint32_t b = p_bits[q * W + k];
    s_row[2 * R + k] = static_cast<int>(b);
    wants |= b != 0u;
  }
  wants = __any_sync(kFull, wants);
  if (lane == 0) *s_wants = wants;
}

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

// The first two terms of the total, left to right: w0*LeastAllocated +
// w1*BalancedAllocation on the cpu and memory columns. They need neither
// feasible-set maximum.
__device__ __forceinline__ float resource_score(const int* a, const int* z, int pnz0, int pnz1,
                                                const Weights& w) {
  const float cap0 = static_cast<float>(a[0]);
  const float cap1 = static_cast<float>(a[1]);
  const float r0 = static_cast<float>(wrap_add(z[0], pnz0));
  const float r1 = static_cast<float>(wrap_add(z[1], pnz1));
  const float least = floorf(__fdiv_rn(__fadd_rn(least_col(cap0, r0), least_col(cap1, r1)), 2.0f));
  const float diff = fabsf(__fsub_rn(frac_col(cap0, r0), frac_col(cap1, r1)));
  const float balanced = floorf(__fmul_rn(__fsub_rn(1.0f, __fdiv_rn(diff, 2.0f)), 100.0f));
  return __fadd_rn(__fmul_rn(w.fit, least), __fmul_rn(w.balanced, balanced));
}

// barrier.cluster split in two, so that work that needs no other block's
// data runs while the barrier completes. Warp 0 holds the only stores that
// other blocks read, so it alone arrives with release semantics, which wait
// for its stores to land; the other warps arrive relaxed. Wait acquires every
// released store.
__device__ __forceinline__ void cluster_arrive(bool release) {
  if (release)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (value, index, total) argmax: larger value wins, equal values keep the
// smaller index; the butterfly over offsets below `width` leaves the result
// of each group of `width` lanes in every lane of the group
__device__ __forceinline__ void warp_argmax(float& v, int& i, float& t, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1) {
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

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    fused_step_batch_kernel(
        const int* __restrict__ alloc, int* requested, int* nonzero, uint32_t* ports,
        const int* __restrict__ p_req, const int* __restrict__ p_nz,
        const uint32_t* __restrict__ p_bits, const uint8_t* __restrict__ static_ok,
        const int8_t* __restrict__ static_ff, const float* __restrict__ taint,
        const float* __restrict__ aff, const float* __restrict__ img,
        const float* __restrict__ jitter, const int* __restrict__ nominated,
        const uint8_t* __restrict__ p_valid, Weights w, int* __restrict__ node_idx,
        float* __restrict__ best, uint8_t* __restrict__ any_feasible, uint8_t* fit_ok,
        uint8_t* ports_ok, int8_t* __restrict__ first_fail, int P, int N, int R, int W) {
  // three pod rows of R requests, R nonzero requests and W port words, and
  // whether each wants a host port: pod p's in buffer p % 3. Warp 0 fills
  // pod p+1's at the top of pod p; the last reader of that buffer, pod p-2's
  // committing warp, has arrived at pod p-1's barrier 1 by then.
  extern __shared__ int s_rows[];
  __shared__ int s_wants[3];
  __shared__ float s_tmax[kWarps], s_amax[kWarps], s_eff[kWarps], s_tot[kWarps];
  __shared__ int s_any[kWarps], s_idx[kWarps];
  // Slot k of each array holds block k's partial and candidate: every block
  // stores its own into slot `rank` of all blocks (a remote store does not
  // wait for a round trip, a remote load does), and reads all 8 locally
  // after the barrier. One array of each is enough, without double
  // buffering: a slot is rewritten only after every block has passed the
  // cluster barrier that follows its last read of it. s_partial is read
  // between barriers 1 and 2 of a pod and rewritten before barrier 1 of the
  // next; s_cand is read between barrier 2 and the next pod's barrier 1 and
  // rewritten before the next pod's barrier 2.
  __shared__ Partial s_partial[kCluster];
  __shared__ Candidate s_cand[kCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int slice = (N + kCluster - 1) / kCluster;
  const int lo = min(N, rank * slice);  // this block's node slots: [lo, hi)
  const int hi = min(N, lo + slice);
  const Rows rows{static_ok, static_ff, taint, aff, img, jitter};

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Warp 0 leads and owns no node; the other warps' threads own the nodes
  // n0, n0 + kNodeThreads, ... of the slice (one each for N <= 8 * 992).
  // A node's carry rows are read and written by its owner thread only.
  const int n0 = warp == 0 ? hi : lo + tid - 32;
  const int row_len = 2 * R + W;

  if (warp == 0 && P > 0) load_pod_row(p_req, p_nz, p_bits, 0, R, W, s_rows, &s_wants[0], lane);
  __syncthreads();
  // the current pod's values at the first node; the next pod's are loaded
  // while the current pod's barrier 2 completes
  NodeRow v0 = n0 < hi && P > 0 ? rows.at(n0) : NodeRow{};

  for (int p = 0; p < P; ++p) {
    PHASE_STAMP(0);
    const size_t row = static_cast<size_t>(p) * N;
    const int* s_req = s_rows + (p % 3) * row_len;
    const int* s_nz = s_req + R;
    const uint32_t* s_bits = reinterpret_cast<const uint32_t*>(s_req + 2 * R);
    const bool wants_ports = s_wants[p % 3] != 0;
    const int nom = nominated[p];
    const bool valid = p_valid[p] != 0;
    if (warp == 0 && p + 1 < P)  // lands while the other warps run pass 1
      load_pod_row(p_req, p_nz, p_bits, p + 1, R, W, s_rows + ((p + 1) % 3) * row_len,
                   &s_wants[(p + 1) % 3], lane);

    // ---- pass 1: feasibility, first-fail ids, feasible-set maxima
    PHASE_STAMP(1);
    float tmax = -INFINITY, amax = -INFINITY;
    int anyf = 0;
    bool feas0 = false;
    for (int n = n0; n < hi; n += kNodeThreads) {
      const NodeRow v = n == n0 ? v0 : rows.at(row + n);
      const int* a = alloc + static_cast<size_t>(n) * R;
      const int* rq = requested + static_cast<size_t>(n) * R;
      bool fit = true;
      for (int r = 0; r < R; ++r) {
        // every thread skips a column the pod does not request; the loads of
        // the others do not wait on each other
        const int pr = s_req[r];
        if (pr != 0) fit &= pr <= wrap_sub(a[r], rq[r]);
      }
      bool pok = true;
      if (wants_ports) {
        const uint32_t* pw = ports + static_cast<size_t>(n) * W;
        for (int k = 0; k < W; ++k) pok &= (pw[k] & s_bits[k]) == 0u;
      }
      const bool feas = v.ok && fit && pok;
      fit_ok[row + n] = fit;
      ports_ok[row + n] = pok;
      int8_t ff = v.ff;
      if (ff == 0 && !pok) ff = 5;
      if (ff == 0 && !fit) ff = 6;
      first_fail[row + n] = ff;
      tmax = fmaxf(tmax, feas ? v.taint : 0.0f);
      amax = fmaxf(amax, feas ? v.aff : 0.0f);
      anyf |= feas;
      if (n == n0) feas0 = feas;
    }
    PHASE_STAMP(2);
    tmax = warp_max(tmax);
    amax = warp_max(amax);
    anyf = __any_sync(kFull, anyf);
    if (lane == 0) {
      s_tmax[warp] = tmax;
      s_amax[warp] = amax;
      s_any[warp] = anyf;
    }
    __syncthreads();
    if (warp == 0) {
      tmax = warp_max(s_tmax[lane]);
      amax = warp_max(s_amax[lane]);
      anyf = __any_sync(kFull, s_any[lane]);
      if (lane < kCluster)
        *cluster.map_shared_rank(&s_partial[rank], lane) = Partial{tmax, amax, anyf, 0};
    }
    PHASE_STAMP(3);
    cluster_arrive(warp == 0);  // barrier 1: every block's partial is in place
    // the first node's resource score needs no other block: it runs while
    // the barrier completes
    const int pnz0 = s_nz[0], pnz1 = s_nz[1];
    const float res0 = n0 < hi ? resource_score(alloc + static_cast<size_t>(n0) * R,
                                                nonzero + static_cast<size_t>(n0) * R,
                                                pnz0, pnz1, w)
                               : 0.0f;
    PHASE_STAMP(4);
    cluster_wait();
    PHASE_STAMP(5);
    {  // lane l combines block l % 8's partial: three rounds cover all 8
      const Partial q = s_partial[lane & (kCluster - 1)];
      tmax = q.tmax;
      amax = q.amax;
      for (int o = kCluster / 2; o > 0; o >>= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, o));
        amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
      }
      anyf = __any_sync(kFull, q.any);
    }

    // ---- pass 2: scores and the jittered masked argmax
    PHASE_STAMP(6);
    float bv = -INFINITY, bt = 0.0f;
    int bi = INT_MAX;
    for (int n = n0; n < hi; n += kNodeThreads) {
      const bool first_node = n == n0;
      const NodeRow v = first_node ? v0 : rows.at(row + n);
      const bool feas =
          first_node ? feas0 : v.ok && fit_ok[row + n] && ports_ok[row + n];
      float total = first_node ? res0
                               : resource_score(alloc + static_cast<size_t>(n) * R,
                                                nonzero + static_cast<size_t>(n) * R,
                                                pnz0, pnz1, w);
      total = __fadd_rn(total, __fmul_rn(w.taint, normalize(v.taint, tmax, true)));
      total = __fadd_rn(total, __fmul_rn(w.affinity, normalize(v.aff, amax, false)));
      total = __fadd_rn(total, __fmul_rn(w.image, v.img));
      const float eff =
          feas ? __fadd_rn(__fadd_rn(total, v.jitter), n == nom ? kNominated : 0.0f) : kNegInf;
      if (eff > bv) {  // ascending n: the first maximum of this thread stays
        bv = eff;
        bi = n;
        bt = total;
      }
    }
    PHASE_STAMP(7);
    warp_argmax(bv, bi, bt);
    if (lane == 0) {
      s_eff[warp] = bv;
      s_idx[warp] = bi;
      s_tot[warp] = bt;
    }
    __syncthreads();
    if (warp == 0) {
      bv = s_eff[lane];
      bi = s_idx[lane];
      bt = s_tot[lane];
      warp_argmax(bv, bi, bt);
      if (lane < kCluster)
        *cluster.map_shared_rank(&s_cand[rank], lane) = Candidate{bv, bi, bt, 0};
    }
    PHASE_STAMP(8);
    cluster_arrive(warp == 0);  // barrier 2: every block's candidate is in place
    // this pod's values are spent: the next pod's device-memory round trip
    // runs while the barrier completes
    if (n0 < hi && p + 1 < P) v0 = rows.at(row + N + n0);
    PHASE_STAMP(9);
    cluster_wait();
    PHASE_STAMP(10);

    // ---- the cluster's winner, in every warp; its owner thread commits
    const Candidate c = s_cand[lane & (kCluster - 1)];
    bv = c.eff;
    bi = c.idx;
    bt = c.tot;
    warp_argmax(bv, bi, bt, kCluster);
    const bool commit = anyf && valid;
    if (rank == 0 && tid == 0) {
      node_idx[p] = commit ? bi : -1;
      best[p] = bt;
      any_feasible[p] = commit;
    }
    // The warp of the winner's owner thread commits, a lane per entry. The
    // owner is the only thread that reads these rows, so after __syncwarp()
    // the next pod sees the commit without a block barrier.
    if (commit && lo <= bi && bi < hi && warp == 1 + (bi - lo) % kNodeThreads / 32) {
      for (int r = lane; r < R; r += 32) {
        const size_t at = static_cast<size_t>(bi) * R + r;
        requested[at] = wrap_add(requested[at], s_req[r]);
        nonzero[at] = wrap_add(nonzero[at], s_nz[r]);
      }
      if (wants_ports)  // or-ing zero words changes nothing
        for (int k = lane; k < W; k += 32) ports[static_cast<size_t>(bi) * W + k] |= s_bits[k];
      __syncwarp();
    }
    PHASE_STAMP(11);
  }
  // Every remote store precedes the last pod's barrier 2; this barrier keeps
  // every block resident until all are done, as any kernel that accesses
  // another block's shared memory must
  cluster.sync();
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
  const size_t smem = static_cast<size_t>(3 * (2 * R + W)) * sizeof(int);
  // one cluster: the grid is exactly the kCluster blocks of __cluster_dims__
  fused_step_batch_kernel<<<kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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

#ifdef KTPU_PHASE_STAMPS
// The stamps as [kCluster, kStampPods, kStamps] int64 into host memory
extern "C" int ktpu_read_phase_stamps(void* host, int pods, int stamps) {
  if (pods != kStampPods || stamps != kStamps) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps)));
}
#endif
