// The decode paged-attention kernel for Hopper (sm_90a), bf16 q at S = 1:
// paged_attention_decode_kernel<D, QUANT>, included by paged_attention.cu.
//
// Replaces, for the decode call (one query position a slot, bf16 q, a bf16
// or int8 page pool, G = NQ / NKV <= MAX_G), the TPU kernel
// neuronx_distributed_tpu/ops/paged_attention.py:_paged_kernel (pallas_call
// in _paged_attention_impl), its int8 branch (:211-221) and its split-K
// epilogue (:407-420) included.  It computes what paged_attention_kernel
// computes at S = 1 (the note at the top of paged_attention.cu): the G q
// heads of kv head h see keys [max(kv_start, off - window + 1), off] of
// their slot; softcap * tanh(score / softcap) before the mask; a parked slot
// (off >= PP * page) and a row with no visible key write exact zeros.
//
// What bounds it on the H100: bytes.  A decode step reads each K/V element
// of the visible range once and does 4 * G flops with it (at most 32 a bf16
// element), far below the ~295 flops a byte at which the tensor cores are
// the limit.  What the design does about it:
// - One block per (slot, kv head, split): the G rows of a kv head share
//   every K/V byte read.  The split's keys are cut into 16-key slices; warp
//   w takes slices w, w + WARPS, ... as a stream of its own, with its own
//   online softmax, so the main loop has no block barrier.
// - A cp.async ring per warp (Cfg::STAGES slices, <= 64 KB a block): each
//   key's K and V rows are 16-byte copies from its own page (its
//   block-table entry looked up one slice ahead, clamped to NP - 1; keys
//   past the range zero-filled), and the next STAGES - 1 slices' copies
//   are in flight while one is used.
// - The products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   sums): S^T = K q^T puts the 16 keys on M and the <= 8 q rows on N; P^T
//   comes out of the S^T accumulator by movmatrix (a warp's transpose of
//   8 x 8 bf16 tiles), rounded to bf16 as the TPU kernel does (:247,
//   p.astype(v.dtype)); O^T += V^T P^T puts D on M.  A thread reads its A
//   operands from the ring with 16-byte loads: the MMA's k index (K's
//   columns) and m index (V's columns) are permuted so that each thread's
//   elements are contiguous, and q and the output follow the permutation.
//   The ring's 16-byte chunks are XOR-swizzled in each row (swizzle()).
// - int8 pages are dequantized in registers between the ring and the MMA:
//   a code's byte, top bit flipped, under the exponent of 2^23 is the
//   float 2^23 + (c + 128); fma(x, scale, -2^23 * scale) is (c + 128) *
//   scale rounded once (the subtraction is exact), then + zero rounded
//   apart, then one rounding to bf16: the bits kvcache.quant's
//   dequantize_page gives in q's type.  No int-to-float conversion.  Each
//   key's page params come by cp.async beside its rows (the lanes of one
//   page read one address, which one request serves).
// - The split-K merge inside the launch: the split_k <= MAX_CLUSTER blocks
//   of one (slot, kv head) form a thread-block cluster.  A block arrives on
//   the cluster barrier when its ring is used up and merges its warps'
//   (m, l, O); after the barrier's wait (every rank's ring is free) it
//   writes that partial into an inbox in rank 0's shared memory through
//   distributed shared memory, and each thread arrives on rank 0's
//   mbarrier, releasing its writes at cluster scope, and exits.  Rank 0
//   waits on the mbarrier, merges the inbox by logsumexp weight and writes
//   out [B, 1, NQ, D] in bf16; no block reads another's shared memory, so
//   none has to outlive the others.  An empty split (m = NEG_INF, l = 0,
//   O = 0) weighs nothing.  More splits than a cluster holds write the
//   fp32 workspace for merge_splits_kernel.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace paged_decode {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's finite sentinel
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int SLICE = 16;       // keys a warp takes at a time: M of m16n8k16
constexpr int MAX_G = 8;        // q rows of one kv head: N of m16n8k16
constexpr int MAX_CLUSTER = 8;  // the portable thread-block cluster size
// ring bytes a block: three blocks an SM, so that all of a decode call's
// clusters fit on the card at once (with rings of ~96 KB, two blocks an
// SM, the H100 holds fewer clusters of 4 than Llama-3-8B's 8 slots x 8 kv
// heads launch, and the call runs in two waves; chip_smoke.py phase 0
// logs the count held)
constexpr int RING_BUDGET = 64 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// how a block's partial reaches the output
enum Merge { DIRECT = 0, CLUSTER = 1, WORKSPACE = 2 };

template <int D, bool QUANT>
struct Cfg {
  static constexpr int ELEM = QUANT ? 1 : 2;   // bytes of a pool element
  static constexpr int ROW_BYTES = D * ELEM;   // one key's K (or V) row
  static constexpr int CPR = ROW_BYTES / 16;   // 16-byte chunks a row
  static constexpr int SWZ = (CPR < 8 ? CPR : 8) - 1;
  // a D = 256 slice is 16 KB: two warps keep two stages each in budget
  static constexpr int WARPS = D >= 256 ? 2 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int KV_BYTES = SLICE * ROW_BYTES;          // K or V
  static constexpr int PAR_BYTES = QUANT ? SLICE * 16 : 0;     // float4 a key
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + PAR_BYTES;
  static constexpr int FIT = RING_BUDGET / (WARPS * STAGE_BYTES);
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
  static constexpr int RING_BYTES = WARPS * STAGES * STAGE_BYTES;
  // the epilogue, over the ring: every warp's O [MAX_G][D], m and l
  // [MAX_G]; a cluster's rank 0 receives the ranks' partials after it
  static constexpr int EPI_BYTES = 4 * WARPS * MAX_G * (D + 2);
  // 16 bytes of mbarrier, then the ring (or the epilogue and the inbox)
  static constexpr int bytes =
      16 + (RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES);
  // the inbox of split_k ranks' (O [G][D], m [G], l [G])
  static constexpr int inbox_bytes(int split_k, int G) {
    return 4 * split_k * G * (D + 2);
  }
  static constexpr int bytes_for(int split_k, int G, bool cluster) {
    return cluster && EPI_BYTES + inbox_bytes(split_k, G) > RING_BYTES
               ? 16 + EPI_BYTES + inbox_bytes(split_k, G)
               : bytes;
  }
  static_assert(D % 64 == 0, "head dims 64, 128 and 256");
  static_assert(SLICE * CPR % 32 == 0, "a slice's chunks fill whole warps");
  static_assert(bytes <= 75 * 1024, "three blocks an SM");
  static_assert(EPI_BYTES % 16 == 0, "the inbox holds float4 rows");
};

// 4 bytes (0 or 4 read) from device memory into shared memory
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// c += A B: A 16 x 16 (row), B 16 x 8 (col), bf16; c 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the warp's 8 x 8 bf16 tile (lane l holds row l / 4, columns 2 (l % 4)
// and + 1) transposed, in the same layout
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// byte e of a word of int8 codes whose top bits were flipped (bytes c +
// 128), as the float 2^23 + (c + 128)
__device__ __forceinline__ float biased_code(uint32_t flipped, int e) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7650 + e));
}

// one page's params for the dequant: scale, -2^23 * scale (exact), zero
struct Dequant {
  float scale, nbias, zero;
};
__device__ __forceinline__ Dequant dequant_of(float scale, float zero) {
  return Dequant{scale, __fmul_rn(scale, -8388608.f), zero};
}
// (c + 128) * scale + zero from biased_code's float, the multiply and the
// add rounded apart
__device__ __forceinline__ float deq(const Dequant& p, float biased) {
  return __fadd_rn(__fmaf_rn(biased, p.scale, p.nbias), p.zero);
}

// the cluster's barrier in two halves: arrive (releasing this thread's
// writes) early, wait (acquiring every thread's) late
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one arrival on the mbarrier at `bar`'s place in the shared memory of
// cluster rank `rank`, releasing this thread's writes at cluster scope
__device__ __forceinline__ void arrive_remote(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(hopper::smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// waits until phase `parity` of the local mbarrier completes, acquiring
// what its arrivals released at cluster scope
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hopper::smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// where the 16-byte chunk cc of key row r sits in its row of a stage's
// tile: XOR-swizzled (within each group of 8 chunks, so the map is one to
// one) by the row plus the group, so that the 16-byte loads of a quarter
// row (K) and of an eighth (V) by 8 lanes hit at most 2 lanes a bank group
template <int SWZ>
__device__ __forceinline__ int swizzle(int r, int cc) {
  return cc ^ ((r + (cc >> 3)) & SWZ);
}

// the 16-byte chunk cc of key row r of a stage's K (or V) tile
template <int ROW_BYTES, int SWZ>
__device__ __forceinline__ const unsigned char* chunk(
    const unsigned char* tile, int r, int cc) {
  return tile + r * ROW_BYTES + (swizzle<SWZ>(r, cc) << 4);
}

// grid = (split_k, NKV, B), THREADS threads; clusters of split_k blocks
// along x when merge == CLUSTER.  merge == DIRECT (split_k == 1) writes out
// [B, 1, NQ, D] in bf16; CLUSTER merges the cluster's blocks into out;
// WORKSPACE writes unnormalised fp32 partials acc [B, NKV, sk, G, D] and
// natural-log m, l [B, NKV, sk, G] for merge_splits_kernel.
template <int D, bool QUANT>
__global__ void __launch_bounds__(Cfg<D, QUANT>::THREADS, 3)
    paged_attention_decode_kernel(
        const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pages,
        const void* __restrict__ v_pages, const float* __restrict__ k_scale,
        const float* __restrict__ k_zero, const float* __restrict__ v_scale,
        const float* __restrict__ v_zero, const int* __restrict__ block_table,
        const int* __restrict__ cache_offset, const int* __restrict__ kv_start,
        __nv_bfloat16* __restrict__ out, float* __restrict__ acc_out,
        float* __restrict__ m_out, float* __restrict__ l_out, int NQ, int NKV,
        int NP, int page, int PP, float sm_scale, int window, float softcap,
        int split_k, int merge) {
  using C = Cfg<D, QUANT>;
  using namespace hopper;
  constexpr int ST = C::STAGES, W = C::WARPS, RB = C::ROW_BYTES;
  constexpr int ACC = D / 64;  // S^T accumulators: chains of 4 products
  extern __shared__ __align__(128) unsigned char pd_smem[];
  // rank 0's count of the other ranks' threads' partials (CLUSTER)
  uint64_t* inbox_full = reinterpret_cast<uint64_t*>(pd_smem);
  unsigned char* base = pd_smem + 16;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = NQ / NKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int T = PP * page;

  // the split's share of the visible keys [lo, hi], in whole slices
  int lo = 0, hi = -1;
  const int off = cache_offset[b];
  if (off < T) {
    hi = off;
    lo = max(kv_start[b], 0);
    if (window > 0) lo = max(lo, off - window + 1);
    if (hi >= lo) {
      const int n = hi - lo + 1;
      const int per = ((n + split_k - 1) / split_k + SLICE - 1) / SLICE * SLICE;
      lo += split * per;
      hi = min(hi, lo + per - 1);
    }
  }
  const int n_slices = hi >= lo ? (hi - lo) / SLICE + 1 : 0;
  const int mine = n_slices > warp ? (n_slices - warp + W - 1) / W : 0;
  if (merge == CLUSTER && split == 0 && threadIdx.x == 0) {
    hopper::mbar_init(inbox_full, (split_k - 1) * C::THREADS);
    hopper::mbar_fence_init();  // seen by the ranks that arrive on it
  }

  // q row g (q head h * G + g; zeros past G) at d = t * D / 4 + e, word i
  // holding e = 2i and 2i + 1: the B operand of S^T = K q^T
  uint32_t qf[D / 8];
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        q + ((long long)b * NQ + h * G + min(g, G - 1)) * D + t * (D / 4));
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const uint4 u = g < G ? src[i] : make_uint4(0u, 0u, 0u, 0u);
      qf[4 * i] = u.x;
      qf[4 * i + 1] = u.y;
      qf[4 * i + 2] = u.z;
      qf[4 * i + 3] = u.w;
    }
  }

  unsigned char* ring = base + warp * ST * C::STAGE_BYTES;
  const unsigned char* kp = static_cast<const unsigned char*>(k_pages);
  const unsigned char* vp = static_cast<const unsigned char*>(v_pages);
  const int* bt = block_table + (long long)b * PP;
  const long long pool_row = (long long)NKV * RB;  // bytes between keys

  // key `lane` (< SLICE) of the warp's slice i: its block-table entry (0
  // past the range), loaded at least one slice before the copies need it
  auto look_up = [&](int i) {
    const int pos = lo + (warp + i * W) * SLICE + lane;
    return lane < SLICE && i < mine && pos <= hi ? bt[pos / page] : 0;
  };
  // the warp's slice i into stage i % ST: K and V rows (keys past hi
  // zero-filled) and, for an int8 pool, each key's page params
  auto issue = [&](int i, int phys) {
    unsigned char* st = ring + (i % ST) * C::STAGE_BYTES;
    const int pos = lo + (warp + i * W) * SLICE + lane;
    const bool ok = lane < SLICE && pos <= hi;
    phys = min(max(phys, 0), NP - 1);
    const int row = ok ? phys * page + pos % page : -1;  // pool row of the key
#pragma unroll 4
    for (int c = lane; c < SLICE * C::CPR; c += 32) {
      const int r = c / C::CPR, cc = c % C::CPR;
      const int rr = __shfl_sync(FULL, row, r);
      const long long src =
          rr < 0 ? 0 : rr * pool_row + (long long)h * RB + cc * 16;
      const int dst = r * RB + (swizzle<C::SWZ>(r, cc) << 4);
      cp_async16(st + dst, kp + src, rr < 0 ? 0 : 16);
      cp_async16(st + C::KV_BYTES + dst, vp + src, rr < 0 ? 0 : 16);
    }
    if constexpr (QUANT) {
      if (lane < SLICE) {  // (k scale, k zero, v scale, v zero) of key lane
        float* par = reinterpret_cast<float*>(st + 2 * C::KV_BYTES) + 4 * lane;
        const int n = ok ? 4 : 0;
        cp_async4(par, k_scale + phys, n);
        cp_async4(par + 1, k_zero + phys, n);
        cp_async4(par + 2, v_scale + phys, n);
        cp_async4(par + 3, v_zero + phys, n);
      }
    }
  };

  // O^T: m-tile mt, row g is d = g * D / 8 + 2 mt, row g + 8 is d + 1;
  // columns 2t, 2t + 1 are q rows
  float o[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
    o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // base 2
  const bool cap = softcap > 0.f;
  const float mul = cap ? 2.f * sm_scale * LOG2E / softcap : sm_scale * LOG2E;
  const float cap_out = softcap * LOG2E;
  // the keys of this thread's V rows in a slice
  const int kv4[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};

  // the first ST slices' entries at once, then one slice ahead
  int first[ST];
#pragma unroll
  for (int i = 0; i < ST; ++i) first[i] = look_up(i);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {  // group i holds slice i (or nothing)
    if (i < mine) issue(i, first[i]);
    cp_async_commit();
  }
  int phys_next = first[ST - 1];
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<ST - 2>();  // this lane's copies of slice i have landed
    __syncwarp();             // and every lane's; slice i - 1 is used up
    if (i + ST - 1 < mine) {
      const int phys = phys_next;
      phys_next = look_up(i + ST);
      issue(i + ST - 1, phys);
    }
    cp_async_commit();

    const unsigned char* ks = ring + (i % ST) * C::STAGE_BYTES;
    const unsigned char* vs = ks + C::KV_BYTES;
    const float4* par = reinterpret_cast<const float4*>(ks + 2 * C::KV_BYTES);
    const int t0 = lo + (warp + i * W) * SLICE;

    // S^T = K q^T: rows g and g + 8 (keys), thread t's quarter of D; the
    // k-steps go to ACC accumulators in turn, so that D / 16 products do
    // not wait on each other, and are summed after
    float sa[ACC][4];
#pragma unroll
    for (int a = 0; a < ACC; ++a)
      sa[a][0] = sa[a][1] = sa[a][2] = sa[a][3] = 0.f;
    if constexpr (!QUANT) {
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {  // 8 elements: two k-steps
        const int cc = t * (D / 32) + j;
        const uint4 k0 = *reinterpret_cast<const uint4*>(
            chunk<RB, C::SWZ>(ks, g, cc));
        const uint4 k1 = *reinterpret_cast<const uint4*>(
            chunk<RB, C::SWZ>(ks, g + 8, cc));
        mma_bf16(sa[(2 * j) % ACC], k0.x, k1.x, k0.y, k1.y, qf[4 * j],
                 qf[4 * j + 1]);
        mma_bf16(sa[(2 * j + 1) % ACC], k0.z, k1.z, k0.w, k1.w,
                 qf[4 * j + 2], qf[4 * j + 3]);
      }
    } else {
      const float4 p0 = par[g], p1 = par[g + 8];
      const Dequant dk0 = dequant_of(p0.x, p0.y);
      const Dequant dk1 = dequant_of(p1.x, p1.y);
#pragma unroll
      for (int j = 0; j < D / 64; ++j) {  // 16 codes: four k-steps
        const int cc = t * (D / 64) + j;
        const uint4 u0 = *reinterpret_cast<const uint4*>(
            chunk<RB, C::SWZ>(ks, g, cc));
        const uint4 u1 = *reinterpret_cast<const uint4*>(
            chunk<RB, C::SWZ>(ks, g + 8, cc));
        const uint32_t w0[4] = {u0.x ^ 0x80808080u, u0.y ^ 0x80808080u,
                                u0.z ^ 0x80808080u, u0.w ^ 0x80808080u};
        const uint32_t w1[4] = {u1.x ^ 0x80808080u, u1.y ^ 0x80808080u,
                                u1.z ^ 0x80808080u, u1.w ^ 0x80808080u};
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const int kk = 4 * j + kq;
          mma_bf16(sa[kk % ACC],
                   pack_bf16(deq(dk0, biased_code(w0[kq], 0)),
                             deq(dk0, biased_code(w0[kq], 1))),
                   pack_bf16(deq(dk1, biased_code(w1[kq], 0)),
                             deq(dk1, biased_code(w1[kq], 1))),
                   pack_bf16(deq(dk0, biased_code(w0[kq], 2)),
                             deq(dk0, biased_code(w0[kq], 3))),
                   pack_bf16(deq(dk1, biased_code(w1[kq], 2)),
                             deq(dk1, biased_code(w1[kq], 3))),
                   qf[2 * kk], qf[2 * kk + 1]);
        }
      }
    }

    // online softmax in base 2 over the slice's keys; S^T[e] is key g + 8
    // (e / 2) of q row 2t + e % 2; keys past hi (the last slice) get p = 0
    const bool edge = t0 + SLICE - 1 > hi;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = sa[0][e];
#pragma unroll
      for (int a = 1; a < ACC; ++a) y += sa[a][e];
      y *= mul;
      if (cap)  // cap * tanh(score / cap) in base 2
        y = fmaf(-2.f * cap_out, rcp(ex2(y) + 1.f), cap_out);
      if (edge && t0 + g + 8 * (e >> 1) > hi) y = -INFINITY;
      x[e] = y;
    }
    float mx[2] = {fmaxf(x[0], x[2]), fmaxf(x[1], x[3])}, alpha[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1)
        mx[c] = fmaxf(mx[c], __shfl_xor_sync(FULL, mx[c], sh));
      const float m_new = fmaxf(m_run[c], mx[c]);
      alpha[c] = ex2(m_run[c] - m_new);
      m_run[c] = m_new;
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = ex2(x[e] - m_run[e & 1]);
    l_run[0] = l_run[0] * alpha[0] + (p[0] + p[2]);
    l_run[1] = l_run[1] * alpha[1] + (p[1] + p[3]);
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {  // a row's max moved
        o[mt][0] *= alpha[0];
        o[mt][1] *= alpha[1];
        o[mt][2] *= alpha[0];
        o[mt][3] *= alpha[1];
      }
    }
    // P^T as the B operand: keys 2t, 2t + 1 (+ 8) of q row g
    const uint32_t pb0 = transpose8x8(pack_bf16(p[0], p[1]));
    const uint32_t pb1 = transpose8x8(pack_bf16(p[2], p[3]));

    // O^T += V^T P^T: keys kv4, thread g's eighth of D
    if constexpr (!QUANT) {
#pragma unroll
      for (int j = 0; j < D / 64; ++j) {  // 8 elements: four m-tiles
        const int cc = g * (D / 64) + j;
        uint4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = *reinterpret_cast<const uint4*>(
              chunk<RB, C::SWZ>(vs, kv4[k], cc));
        const uint32_t w0[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
        const uint32_t w1[4] = {v[1].x, v[1].y, v[1].z, v[1].w};
        const uint32_t w2[4] = {v[2].x, v[2].y, v[2].z, v[2].w};
        const uint32_t w3[4] = {v[3].x, v[3].y, v[3].z, v[3].w};
#pragma unroll
        for (int wq = 0; wq < 4; ++wq)
          mma_bf16(o[4 * j + wq], __byte_perm(w0[wq], w1[wq], 0x5410),
                   __byte_perm(w0[wq], w1[wq], 0x7632),
                   __byte_perm(w2[wq], w3[wq], 0x5410),
                   __byte_perm(w2[wq], w3[wq], 0x7632), pb0, pb1);
      }
    } else {
      const float4 q0 = par[kv4[0]], q1 = par[kv4[1]], q2 = par[kv4[2]],
                   q3 = par[kv4[3]];
      const Dequant dv[4] = {dequant_of(q0.z, q0.w), dequant_of(q1.z, q1.w),
                             dequant_of(q2.z, q2.w), dequant_of(q3.z, q3.w)};
#pragma unroll
      for (int j = 0; j < D / 64; ++j) {  // 8 codes: four m-tiles
        const int at = g * (D / 8) + 8 * j;  // byte of the row
        uint2 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = *reinterpret_cast<const uint2*>(
              chunk<RB, C::SWZ>(vs, kv4[k], at >> 4) + (at & 8));
#pragma unroll
        for (int wq = 0; wq < 2; ++wq) {
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[k] = (wq ? v[k].y : v[k].x) ^ 0x80808080u;
#pragma unroll
          for (int hb = 0; hb < 4; hb += 2)  // codes hb, hb + 1 of the word
            mma_bf16(o[4 * j + 2 * wq + hb / 2],
                     pack_bf16(deq(dv[0], biased_code(w[0], hb)),
                               deq(dv[1], biased_code(w[1], hb))),
                     pack_bf16(deq(dv[0], biased_code(w[0], hb + 1)),
                               deq(dv[1], biased_code(w[1], hb + 1))),
                     pack_bf16(deq(dv[2], biased_code(w[2], hb)),
                               deq(dv[3], biased_code(w[3], hb))),
                     pack_bf16(deq(dv[2], biased_code(w[2], hb + 1)),
                               deq(dv[3], biased_code(w[3], hb + 1))),
                     pb0, pb1);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (merge == CLUSTER) cluster_arrive();  // this block's ring is free

  // ---- epilogue: the warps' partials, then the block's, then the split's
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int sh = 4; sh < 32; sh <<= 1)
      l_run[c] += __shfl_xor_sync(FULL, l_run[c], sh);
  __syncthreads();  // every warp is done with the ring
  float* wO = reinterpret_cast<float*>(base);  // [W][MAX_G][D]
  float* wm = wO + W * MAX_G * D;              // [W][MAX_G]
  float* wl = wm + W * MAX_G;
  // rank 0's inbox: split_k ranks' O [G][D], then m [G], then l [G]
  float* inbox = reinterpret_cast<float*>(base + C::EPI_BYTES);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int n = 2 * t + c;
    if (n < G) {
      if (g == 0) {
        wm[warp * MAX_G + n] = m_run[c];
        wl[warp * MAX_G + n] = l_run[c];
      }
      float* row = wO + (warp * MAX_G + n) * D + g * (D / 8);
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt)
        *reinterpret_cast<float2*>(row + 2 * mt) =
            make_float2(o[mt][c], o[mt][c + 2]);
    }
  }
  __syncthreads();
  namespace cg = cooperative_groups;
  float* to = inbox;  // where this block's partial goes (CLUSTER)
  if (merge == CLUSTER) {
    cluster_wait();  // every rank is done with its ring: the inbox is free
    to = cg::this_cluster().map_shared_rank(inbox, 0);
  }
  // the block's partial: its warps' merged by logsumexp weight
  for (int e = threadIdx.x; e < G * D; e += C::THREADS) {
    const int n = e / D, d = e % D;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < W; ++w) m = fmaxf(m, wm[w * MAX_G + n]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float sc = ex2(wm[w * MAX_G + n] - m);
      acc += wO[(w * MAX_G + n) * D + d] * sc;
      l += wl[w * MAX_G + n] * sc;
    }
    if (merge == DIRECT) {
      out[((long long)b * NQ + h * G + n) * D + d] =
          __float2bfloat16(l > 0.f ? acc / l : 0.f);
    } else if (merge == WORKSPACE) {
      const long long r = ((long long)(b * NKV + h) * split_k + split) * G + n;
      acc_out[r * D + d] = acc;
      if (d == 0) {
        m_out[r] = m * LN2;
        l_out[r] = l;
      }
    } else {
      to[(split * G + n) * D + d] = acc;
      if (d == 0) {
        to[split_k * G * D + split * G + n] = m;
        to[split_k * G * (D + 1) + split * G + n] = l;
      }
    }
  }
  if (merge != CLUSTER) return;
  if (split != 0) {  // this thread's part of the partial is in rank 0's inbox
    arrive_remote(inbox_full, 0);
    return;
  }
  __syncthreads();            // rank 0's own partial is in its inbox
  wait_cluster(inbox_full, 0);  // and every other rank's
  // the split's partials merged by logsumexp weight, 4 outputs a thread
  const float* im = inbox + split_k * G * D;
  const float* il = im + split_k * G;
  for (int u = threadIdx.x; u < G * D / 4; u += C::THREADS) {
    const int n = u / (D / 4), d = u % (D / 4) * 4;
    float m = NEG_INF;
    for (int r = 0; r < split_k; ++r) m = fmaxf(m, im[r * G + n]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < split_k; ++r) {
      const float w = ex2(im[r * G + n] - m);
      const float4 ar =
          *reinterpret_cast<const float4*>(inbox + (r * G + n) * D + d);
      l += il[r * G + n] * w;
      a.x += ar.x * w;
      a.y += ar.y * w;
      a.z += ar.z * w;
      a.w += ar.w * w;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + ((long long)b * NQ + h * G + n) * D + d);
    dst[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    dst[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
}

}  // namespace paged_decode
