// The multi-row paged-attention kernel for Hopper (sm_90a), bf16 q:
// paged_attention_wgmma_kernel<D, QUANT>, included by paged_attention.cu.
//
// Replaces, for query widths S > 1 (prefill chunks, verify rows), the TPU
// kernel neuronx_distributed_tpu/ops/paged_attention.py:_paged_kernel
// (pallas_call in _paged_attention_impl), int8 branch included (:211-221).
// It computes exactly what paged_attention_kernel computes (the note at the
// top of paged_attention.cu): query row r of kv head h is position r / G of
// q head h * G + r % G; row s sees keys [kv_start, off + s], narrowed to the
// last `window` positions; softcap * tanh(score / softcap) before the mask;
// masked keys give p = 0 exactly; a parked slot and a row with no visible
// key write exact zeros; split-K partials are merged by merge_splits_kernel.
//
// What bounds it on the H100: at a 128-token chunk every K/V element read
// serves G * S = 512 query rows (4 * 512 * D flops a key), so the products,
// not the bytes, are the work; the old kernel ran them as scalar fp32 FMAs.
// What the design does about it (the pieces of hopper.cuh, as in the flash
// kernels): one block of three warpgroups per 128 query rows of one kv head
// and one split of its key range.
// - Producer warpgroup (setmaxnreg down): walks the key range in tiles of
//   BKT keys starting at the range's first key.  Per tile, its threads look
//   up each page the tile touches once (block table clamped to NP - 1; an
//   int8 pool's four page params beside it), then issue 16-byte cp.async
//   copies of the raw K/V rows: a bf16 pool's rows land straight in the
//   128-byte-swizzled bf16 panels wgmma reads; an int8 pool's codes land in
//   a staging ring and are dequantized into the panels as (c + 128) * scale
//   + zero, multiply and add rounded separately, then rounded once to bf16,
//   the plain version's dequantize_page to q's type.  Keys past the range
//   are zeros.  The next two tiles' copies are in flight while this tile
//   is dequantized; fence.proxy.async and a "full" mbarrier hand the panels
//   to the consumers, an "empty" mbarrier per stage hands them back.
// - Two consumer warpgroups, 64 query rows each (the block's Q, 128 rows of
//   bf16 panels, is copied once): S = Q K^T by SS wgmma (both K-major), the
//   online softmax on the fp32 accumulator in registers in base 2 (mask code
//   only on edge tiles: the chunk's causal band, the window's left edge, the
//   end of the range), P packed in place to bf16 as the register A operand
//   of O += P V (V MN-major).  Tile i's Q K^T and tile i - 1's P V are
//   issued together, and tile i's softmax runs while that P V is on the
//   tensor cores.
// Key tile 64 keys (32 at D = 256, where the 64 x 256 fp32 O accumulator is
// 128 registers a consumer thread and an int8 pool also needs its staging
// ring); three stages of panels (int8) or four (bf16, whose copies land in
// them).  Not done: a persistent schedule, TMA for the page
// rows (a tile spans several pages, each its own box).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace paged_wgmma {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's finite sentinel
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block can use
constexpr int PRODUCER_BAR = 1;      // named barrier of the producer's threads

template <int D, bool QUANT>
struct Cfg {
  static constexpr int BQ = 128;  // query rows: 2 consumers x 64
  static constexpr int BKT = D >= 256 ? 32 : 64;  // keys per tile
  static constexpr int THREADS = 384;             // producer + 2 consumers
  static constexpr int PANELS = D / hopper::PANEL_COLS;
  static constexpr uint32_t Q_PANEL = BQ * hopper::PANEL_ROW_BYTES;
  static constexpr uint32_t KV_PANEL = BKT * hopper::PANEL_ROW_BYTES;
  static constexpr uint32_t Q_BYTES = Q_PANEL * PANELS;
  static constexpr uint32_t KV_BYTES = KV_PANEL * PANELS;  // one K or V tile
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;    // K then V
  // tiles whose copies are in flight beyond the one being handed over
  static constexpr int LOOKAHEAD = 2;
  // an int8 tile's codes (K then V), one staging slot; slots of the page
  // lookups and staging: the tile handed over and those in flight
  static constexpr uint32_t RAW_BYTES = QUANT ? 2 * BKT * D : 0;
  static constexpr int SLOTS = LOOKAHEAD + 1;
  static constexpr size_t fixed(int stages) {
    return 1024 /* alignment of the first panel */ + Q_BYTES +
           (size_t)stages * STAGE_BYTES + SLOTS * (size_t)RAW_BYTES +
           SLOTS * BKT * (sizeof(float4) + sizeof(int)) +
           8 * (1 + 2 * stages);
  }
  // a bf16 pool's copies of tile i + LOOKAHEAD land in their stage before
  // tile i is handed over, so its stage must already be free: LOOKAHEAD + 2
  static constexpr int STAGES = QUANT ? 3 : LOOKAHEAD + 2;
  static constexpr size_t bytes = fixed(STAGES);
  // registers: the producer dequantizes (more than a TMA thread needs)
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
  static_assert(D % hopper::PANEL_COLS == 0, "D must be whole panels");
  static_assert(bytes <= SMEM_MAX, "paged wgmma tiles exceed shared memory");
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
                "register split exceeds the SM's file");
  static_assert(D / 2 + BKT / 2 + BKT / 4 <= CONSUMER_REGS - 48,
                "consumer accumulators leave too few registers");
  static_assert(QUANT ? STAGES >= 2 : STAGES >= LOOKAHEAD + 2,
                "too few stages: the producer would wait on itself");
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 int8 codes of one page -> 16 bf16 in two 16-byte chunks, each value
// (c + 128) * scale + zero with the multiply and the add rounded apart.
// c + 128 is the code's byte with its top bit flipped, read as unsigned;
// placed under the exponent of 2^23 it is the float 2^23 + (c + 128), so
// one byte permute and one exact subtraction replace the int-to-float
// conversion (which issues at a sixteenth of the FP32 rate).
__device__ __forceinline__ void dequant16(const uint4& u, float scale,
                                          float zero, uint4& lo, uint4& hi) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
  float x[16];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t biased = words[w] ^ 0x80808080u;  // bytes c + 128
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[4 * w + e] =
          __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + e)) -
          8388608.f;
  }
  uint32_t p[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    p[e] = hopper::pack_bf16(
        __fadd_rn(__fmul_rn(x[2 * e], scale), zero),
        __fadd_rn(__fmul_rn(x[2 * e + 1], scale), zero));
  lo = make_uint4(p[0], p[1], p[2], p[3]);
  hi = make_uint4(p[4], p[5], p[6], p[7]);
}

// the key range [lo, hi] of split `split` of the slot's needed range (the
// split's share rounded up to whole tiles; empty when lo > hi)
__device__ __forceinline__ void split_range(int off, int start, int S, int T,
                                            int window, int split_k,
                                            int split, int bkt, int& lo,
                                            int& hi) {
  lo = 0;
  hi = -1;
  if (off >= T) return;  // a parked slot
  hi = min(off + S - 1, T - 1);
  lo = max(start, 0);
  if (window > 0) lo = max(lo, off - window + 1);
  const int n = hi - lo + 1;
  if (n <= 0) return;
  const int per = ((n + split_k - 1) / split_k + bkt - 1) / bkt * bkt;
  lo += split * per;
  hi = min(hi, lo + per - 1);
}

// One key tile's online-softmax step on the S accumulator, in place: the
// scaled (and capped) scores in base 2, the edge tile's mask (masked: -inf,
// so p = 0 exactly), the running max and sum of the thread's two rows, and
// p = 2^(x - m) left in s.  alpha: the factor of the rows' earlier O and l.
template <bool CAP, bool EDGE, int BKT>
__device__ __forceinline__ void softmax_step(float (&s)[BKT / 2],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2], float mul,
                                             float cap_out, int k0, int hi,
                                             const int (&qpos)[2], int window,
                                             int t) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < BKT / 2; ++e) {
    const int r = (e >> 1) & 1;
    float x = s[e] * mul;
    if (CAP)  // cap * tanh(y / cap) in base 2; mul = 2 scale log2(e) / cap
      x = fmaf(-2.f * cap_out, hopper::rcp(hopper::ex2(x) + 1.f), cap_out);
    if (EDGE) {
      const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      const bool ok = kj <= hi && kj <= qpos[r] &&
                      (window <= 0 || kj > qpos[r] - window);
      x = ok ? x : -INFINITY;
    }
    s[e] = x;
    mt[r] = fmaxf(mt[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mt[r]));
    alpha[r] = hopper::ex2(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < BKT / 2; ++e) {
    const int r = (e >> 1) & 1;
    s[e] = hopper::ex2(s[e] - m_run[r]);
    l_run[r] += s[e];
  }
}

// grid = (ceil(G * S / 128), split_k, B * NKV), 384 threads.  Outputs as
// paged_attention_kernel's: split_k == 1 writes out [B, S, NQ, D] in bf16;
// split_k > 1 writes unnormalised fp32 partials acc [B, NKV, sk, G*S, D]
// and natural-log m, l [B, NKV, sk, G*S] for merge_splits_kernel.
template <int D, bool QUANT>
__global__ void __launch_bounds__(Cfg<D, QUANT>::THREADS, 1)
    paged_attention_wgmma_kernel(
        const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pages,
        const void* __restrict__ v_pages, const float* __restrict__ k_scale,
        const float* __restrict__ k_zero, const float* __restrict__ v_scale,
        const float* __restrict__ v_zero, const int* __restrict__ block_table,
        const int* __restrict__ cache_offset, const int* __restrict__ kv_start,
        __nv_bfloat16* __restrict__ out, float* __restrict__ acc_out,
        float* __restrict__ m_out, float* __restrict__ l_out, int S, int NQ,
        int NKV, int NP, int page, int PP, float sm_scale, int window,
        float softcap, int split_k) {
  using C = Cfg<D, QUANT>;
  using namespace hopper;
  constexpr int BQ = C::BQ, BKT = C::BKT, ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char pw_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(pw_smem) + 1023) & ~(uintptr_t)1023);
  unsigned char* Qs = base;                   // [PANELS][BQ][64], swizzled
  unsigned char* KVs = Qs + C::Q_BYTES;       // [ST][K, V][PANELS][BKT][64]
  unsigned char* raw = KVs + ST * C::STAGE_BYTES;  // [SLOTS][K, V][BKT][D]
  float4* pg_par = reinterpret_cast<float4*>(raw + C::SLOTS * C::RAW_BYTES);
  int* pg_phys = reinterpret_cast<int*>(pg_par + C::SLOTS * BKT);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(pg_phys + C::SLOTS * BKT);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int G = NQ / NKV;
  const int rows = G * S;
  const int rb = blockIdx.x, split = blockIdx.y;
  const int b = blockIdx.z / NKV, h = blockIdx.z % NKV;
  const int T = PP * page;
  const int off = cache_offset[b];
  int lo, hi;
  split_range(off, kv_start[b], S, T, window, split_k, split, BKT, lo, hi);
  const int n_tiles = hi >= lo ? (hi - lo) / BKT + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 128);
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 128);     // every producer thread arrives
      mbar_init(&empty[st], 2 * 128);  // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: page lookups, K/V copies, the int8 dequant stage ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (n_tiles == 0) return;
    const int pt = threadIdx.x;
    constexpr int ELEM = QUANT ? 1 : 2;  // bytes of a pool element
    constexpr int CPR = D * ELEM / 16;   // 16-byte chunks of a K/V row
    const unsigned char* kp = static_cast<const unsigned char*>(k_pages);
    const unsigned char* vp = static_cast<const unsigned char*>(v_pages);
    const long long kv_row = (long long)NKV * D;  // elements between keys

    // the pages tile i touches: each one's physical page (and params) once
    auto look_up_pages = [&](int i) {
      const int t0 = lo + i * BKT, slot = i % C::SLOTS;
      const int lp0 = t0 / page;
      const int npg = min(t0 + BKT - 1, hi) / page - lp0 + 1;
      for (int j = pt; j < npg; j += 128) {
        const int phys =
            min(max(block_table[(long long)b * PP + lp0 + j], 0), NP - 1);
        pg_phys[slot * BKT + j] = phys;
        if constexpr (QUANT)
          pg_par[slot * BKT + j] = make_float4(k_scale[phys], k_zero[phys],
                                               v_scale[phys], v_zero[phys]);
      }
    };
    // the raw K/V rows of tile i: into stage i % ST's panels (bf16) or
    // staging slot i % SLOTS (int8); keys past the range are zero-filled
    auto issue_copies = [&](int i) {
      const int t0 = lo + i * BKT, slot = i % C::SLOTS;
      const int lp0 = t0 / page;
      unsigned char* kd;
      unsigned char* vd;
      if constexpr (QUANT) {
        kd = raw + slot * C::RAW_BYTES;
        vd = kd + BKT * D;
      } else {
        kd = KVs + (i % ST) * C::STAGE_BYTES;
        vd = kd + C::KV_BYTES;
      }
      for (int c = pt; c < BKT * CPR; c += 128) {
        const int j = c / CPR, cc = c % CPR, pos = t0 + j;
        const bool ok = pos <= hi;
        long long e = 0;
        if (ok) {
          const int phys = pg_phys[slot * BKT + pos / page - lp0];
          e = (((long long)phys * page + pos % page) * kv_row + (long long)h * D) *
              ELEM;
        }
        uint32_t d;
        if constexpr (QUANT)
          d = j * D + cc * 16;
        else  // bf16 columns 8cc..8cc+7 of row j in the swizzled panels
          d = (cc / 8) * C::KV_PANEL + panel_offset(j, (cc % 8) * 8);
        const long long src = e + cc * 16;
        cp_async16(kd + d, ok ? kp + src : kp, ok ? 16 : 0);
        cp_async16(vd + d, ok ? vp + src : vp, ok ? 16 : 0);
      }
    };
    // int8 tile i: staging slot -> bf16 panels of stage i % ST
    auto dequant_tile = [&](int i) {
      const int t0 = lo + i * BKT, slot = i % C::SLOTS;
      const int lp0 = t0 / page;
      const unsigned char* ks = raw + slot * C::RAW_BYTES;
      unsigned char* kd = KVs + (i % ST) * C::STAGE_BYTES;
      for (int c = pt; c < BKT * (D / 16); c += 128) {
        const int j = c / (D / 16), d0 = (c % (D / 16)) * 16;
        const int pos = t0 + j;
        const uint32_t at =
            (d0 / 64) * C::KV_PANEL + panel_offset(j, d0 % 64);
        const uint32_t at2 =
            (d0 / 64) * C::KV_PANEL + panel_offset(j, d0 % 64 + 8);
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          uint4 lo4 = make_uint4(0, 0, 0, 0), hi4 = lo4;
          if (pos <= hi) {
            const float4 par = pg_par[slot * BKT + pos / page - lp0];
            dequant16(*reinterpret_cast<const uint4*>(ks + kv * BKT * D +
                                                      j * D + d0),
                      kv ? par.z : par.x, kv ? par.w : par.y, lo4, hi4);
          }
          unsigned char* panel = kd + kv * C::KV_BYTES;
          *reinterpret_cast<uint4*>(panel + at) = lo4;
          *reinterpret_cast<uint4*>(panel + at2) = hi4;
        }
      }
    };

    // the block's 128 query rows, once: row r0 + r is position (r0 + r) / G
    // of q head h * G + (r0 + r) % G; rows past G * S are zeros
    {
      const int r0 = rb * BQ;
      for (int c = pt; c < BQ * (D / 8); c += 128) {
        const int r = c / (D / 8), cc = c % (D / 8), gr = r0 + r;
        const bool ok = gr < rows;
        const __nv_bfloat16* src =
            ok ? q + ((long long)(b * S + gr / G) * NQ + h * G + gr % G) * D +
                     cc * 8
               : q;
        cp_async16(Qs + (cc / 8) * C::Q_PANEL + panel_offset(r, (cc % 8) * 8),
                   src, ok ? 16 : 0);
      }
    }
    // tile j's copies: its pages looked up, then (a bf16 pool) its stage
    // free, then the cp.asyncs; every producer thread is done with the
    // slots of tile j - SLOTS first
    auto start_tile = [&](int j) {
      named_barrier_sync(PRODUCER_BAR, 128);
      look_up_pages(j);
      named_barrier_sync(PRODUCER_BAR, 128);
      if constexpr (!QUANT)  // the copies land in the stage's panels
        mbar_wait(&empty[j % ST], ((j / ST) & 1) ^ 1);
      issue_copies(j);
    };
    // group j holds tile j's copies (group 0 Q's too; empty past the end)
    for (int j = 0; j < C::LOOKAHEAD; ++j) {
      if (j < n_tiles) start_tile(j);
      cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      if (i + C::LOOKAHEAD < n_tiles) start_tile(i + C::LOOKAHEAD);
      cp_async_commit();
      // this thread's copies of tile i have landed
      cp_async_wait<C::LOOKAHEAD>();
      if constexpr (QUANT) {
        named_barrier_sync(PRODUCER_BAR, 128);  // and every thread's
        mbar_wait(&empty[i % ST], ((i / ST) & 1) ^ 1);
        dequant_tile(i);
      }
      fence_proxy_async();  // the panels, for the consumers' wgmma
      if (i == 0) mbar_arrive(q_full);
      mbar_arrive(&full[i % ST]);
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int c = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = rb * BQ + 64 * c;  // the warpgroup's first row
    const int rr[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    const int qpos[2] = {off + rr[0] / G, off + rr[1] / G};
    const int s_first = r0 / G;
    const int s_last = min(r0 + 63, rows - 1) / G;
    const bool cap = softcap > 0.f;
    const float mul =
        cap ? 2.f * sm_scale * LOG2E / softcap : sm_scale * LOG2E;
    const float cap_out = softcap * LOG2E;
    const uint32_t q_addr = smem_u32(Qs) + 64 * c * PANEL_ROW_BYTES;

    // the softmax step for tile i, by its mask class
    auto softmax = [&](float (&s)[BKT / 2], float (&m_run)[2],
                       float (&l_run)[2], float (&alpha)[2], int i) {
      const int k0 = lo + i * BKT;
      const int k_last = k0 + BKT - 1;
      const bool edge = k_last > hi || k_last > off + s_first ||
                        (window > 0 && k0 <= off + s_last - window);
      if (edge) {
        if (cap)
          softmax_step<true, true, BKT>(s, m_run, l_run, alpha, mul, cap_out,
                                        k0, hi, qpos, window, t);
        else
          softmax_step<false, true, BKT>(s, m_run, l_run, alpha, mul,
                                         cap_out, k0, hi, qpos, window, t);
      } else {
        if (cap)
          softmax_step<true, false, BKT>(s, m_run, l_run, alpha, mul,
                                         cap_out, k0, hi, qpos, window, t);
        else
          softmax_step<false, false, BKT>(s, m_run, l_run, alpha, mul,
                                          cap_out, k0, hi, qpos, window, t);
      }
    };
    // S = Q K^T of tile i over D, 16 columns a step (issued, not waited)
    auto issue_qk = [&](float (&s)[BKT / 2], int i) {
      const uint32_t k_addr = smem_u32(KVs + (i % ST) * C::STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKT>(
            s, desc_k_major(q_addr + (kk / 4) * C::Q_PANEL + (kk % 4) * 32),
            desc_k_major(k_addr + (kk / 4) * C::KV_PANEL + (kk % 4) * 32),
            kk > 0);
      wgmma_commit();
    };
    // O += P V of tile i (issued, not waited)
    auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[BKT / 16][4],
                        int i) {
      const uint32_t v_addr =
          smem_u32(KVs + (i % ST) * C::STAGE_BYTES + C::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    desc_mn_major(v_addr + kk * 16 * PANEL_ROW_BYTES,
                                  C::KV_PANEL),
                    1);
      wgmma_commit();
    };
    // P (in s after its softmax) as the A fragments of P V, 16 keys each
    auto pack_p = [](const float (&s)[BKT / 2],
                     uint32_t (&pa)[BKT / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          pa[kk][f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
    };

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
    if (n_tiles > 0) {
      float s[BKT / 2];
      uint32_t pa[BKT / 16][4];  // P of the tile whose P V is next
      float alpha[2];
      mbar_wait(q_full, 0);
      mbar_wait(&full[0], 0);
      fence_regs(s);
      wgmma_fence();
      issue_qk(s, 0);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, m_run, l_run, alpha, 0);
      pack_p(s, pa);
      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % ST, sp = (i - 1) % ST;
        mbar_wait(&full[st], (i / ST) & 1);
        fence_regs(s);
        fence_regs(o);
        wgmma_fence();
        issue_qk(s, i);
        issue_pv(o, pa, i - 1);
        wgmma_wait<1>();  // S of tile i is in; P V of tile i - 1 runs on
        fence_regs(s);
        softmax(s, m_run, l_run, alpha, i);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&empty[sp]);  // tile i - 1's K and V are read
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
        pack_p(s, pa);
      }
      const int il = n_tiles - 1;
      fence_regs(o);
      wgmma_fence();
      issue_pv(o, pa, il);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[il % ST]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[r]);
      if (rr[r] >= rows) continue;
      if (split_k == 1) {
        const float inv = l > 0.f ? 1.f / l : 0.f;
        __nv_bfloat16* orow =
            out + ((long long)(b * S + rr[r] / G) * NQ + h * G + rr[r] % G) *
                      D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                    o[4 * j + 2 * r + 1] * inv);
      } else {
        const long long row =
            ((long long)(b * NKV + h) * split_k + split) * rows + rr[r];
        float* arow = acc_out + row * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(arow + 8 * j + 2 * t) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if (t == 0) {  // natural-log max from the base-2 one
          m_out[row] = m_run[r] * LN2;
          l_out[row] = l;
        }
      }
    }
  }
}

}  // namespace paged_wgmma
