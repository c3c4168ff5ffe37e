// Flash-attention forward, dq and dk/dv kernels for Hopper (sm_90a), plain C
// interface.  This header holds the kernels; each library source defines
// FLASH_HEAD_DIMS (the head dims it instantiates) and includes it:
// flash_attention.cu builds D = 64 and 128, flash_attention_d256.cu D = 256.
// FLASH_PART (1 forward, 2 dq, 3 dk/dv; unset: all three), given on the
// nvcc command line, limits a translation unit to one kernel's entry point:
// ops/_build.py compiles the three parts of each library side by side
// (cicc takes minutes on one core for all of them) and links them into
// the one library.
//
// Replaces the three TPU kernels of neuronx_distributed_tpu/ops/
// flash_attention.py: _fwd_kernel (B1, pallas_call in _fwd_impl),
// _dq_kernel (B2) and _dkv_kernel (B3, both pallas_calls in _bwd_impl).
// Layout as in the JAX package: q [B, HQ, S, D], k/v [B, HKV, T, D] with
// HQ = G * HKV (q head h reads kv head h / G); every [*, *, *, D] operand
// is addressed through its own (b, h, s) element strides with a unit
// stride on D, so the model's [B, S, N, D] activations pass as transposed
// views without a copy.  lse and delta are fp32 [B, HQ, S]; segment ids
// int32 [B, S] / [B, T].
//
// What bounds them on the H100: operations.  At the training shapes each
// visible (q, k) pair costs 4*D (forward), 6*D (dq) and 8*D (dk/dv) flops
// against a few bytes per pair of q/k/v traffic, far above the ~295
// flop/byte at which the bf16 tensor cores become the limit.
//
// B1 in bf16, flash_fwd_wgmma_kernel (built from the pieces of hopper.cuh):
// one block of three warpgroups per 128 q rows of one head.  The producer
// warpgroup gives up registers (setmaxnreg) and one of its threads issues
// TMA loads: the block's Q tile once, then every K and V tile of its key
// range into a ring of shared-memory stages, each stage with a "full"
// barrier per operand (TMA bytes) and an "empty" barrier (consumer
// arrivals; K and V apart, so a K stage refills as soon as S is in).  The
// two consumer warpgroups own 64 q rows each: S = Q K^T is one wgmma chain
// from shared memory (both operands K-major, 128-byte swizzled, the layout
// TMA writes); the online softmax runs on the fp32 accumulator in
// registers, in base 2 with log2(e) folded into the scale; P is packed to
// bf16 in place as the register A operand of O += P V (V MN-major by the
// transpose flag), so nothing of P touches shared memory.  The consumer is
// software-pipelined: tile i's Q K^T and tile i - 1's P V are issued
// together, and tile i's softmax runs while that P V is on the tensor
// cores; the two consumers take turns to issue (ping-pong, by named
// barriers), so one's softmax also runs under the other's products.  A
// key tile is interior (no mask code), edge (causal diagonal, the
// window's left edge, keys past T; a tile a consumer's rows cannot see at
// all is fully masked) or segmented (per-element id test).  The
// softcap's tanh is 1 - 2 / (2^(2x log2 e) + 1) from ex2.approx and
// rcp.approx (a few 1e-7 absolute; tanh.approx.f32 errs by ~5e-4).  TMA
// fills rows past S and T with zeros, so no stale value meets a zero
// probability.  Key tile 128 (64 at D = 256, where the 64 x 256 fp32 O
// accumulator alone is 128 registers a consumer thread), two stages: 160 KB
// of shared memory at D = 128, 192 KB at D = 256.  Not yet done (later
// work): a persistent schedule over the q tiles, so that one tile's Q
// load and epilogue overlap another's products (at D = 128 a block walks
// only ~9 key tiles, and its start and end are not hidden).
//
// B2 and B3 in bf16, flash_dq_wgmma_kernel and flash_dkv_wgmma_kernel,
// the same shape: a producer warpgroup (40 registers) TMA-loads the
// block's own tiles once and streams the others through a ring of
// stages, two consumer warpgroups (232 registers) run wgmma; P is
// recomputed from the forward's lse in base 2, dS = P (dP - delta) (1 -
// t^2) scale is formed on the fp32 accumulators, and both are packed to
// bf16 in place as RS A fragments, so nothing of them touches shared
// memory below D = 256.  Tiles are interior (no mask code) or edge
// (causal diagonal, window edge, keys past T, segments).
//   dq: one block per 128 q rows of one head, K/V tiles of 64 keys (32 at
//     D = 256, where dQ alone is 128 registers a thread) in three stages;
//     each consumer owns 64 q rows: S = Q K^T and dP = dO V^T (SS), dQ +=
//     dS K (RS, K MN-major); tile i's dQ product runs while tile i + 1's
//     products are issued.
//   dk/dv: one block per key tile of one kv head, Q/dO tiles of 64 q rows
//     (with their lse and delta rows, also by TMA) over
//     every q head of the group and every q tile that can see the keys;
//     dK and dV are summed in registers and written once (no per-q-head
//     partials, no atomics: deterministic).  D = 64, 128: 128 keys, each
//     consumer owns 64: S^T = K Q^T and dP^T = V dO^T (SS, keys as the M
//     rows), dV += P^T dO and dK += dS^T Q (RS, dO and Q MN-major).  D =
//     256 (dK and dV of 64 keys would be 256 registers a thread): 64 keys
//     split by role, so nothing is recomputed: consumer 0 forms S^T and
//     P^T, consumer 1 dP^T and dS^T, the hand-over through two 128-byte
//     swizzled panels ordered by named barriers, then each consumer takes
//     one column half of dV += P^T dO and dK += dS^T Q (SS, A from the
//     panels, B MN-major); 226 KB of shared memory, two stages.
//
// fp32 (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel): mma.sync
// m16n8k16 tile shapes with the product done in fp32 FMAs by the thread
// that owns each accumulator element; tiles of 64 rows staged by cp.async
// in shared memory (rows padded by 16 bytes); each block walks only the
// tiles its causal, window and segment bounds leave (the TPU kernels'
// pl.when skips become loop bounds); the heaviest causal q tiles are
// scheduled first.  wgmma has no fp32 mode, and TF32 would not hold
// fp32's tolerance, so fp32 stays on these kernels.
//
// Work layout of the fp32 kernels:
//   forward, dq: grid (ceil(S / 64), HQ, B), 4 warps; warp w owns q
//     rows [16w, 16w + 16) of the block's tile and loops over key tiles of
//     64 (32 at D = 256: a warp's 16 x 256 fp32 accumulator alone is 128
//     registers a thread, so the score tile is halved);
//   dk/dv: grid (ceil(T / 64), HKV * D / DC, B), 4 warps; warp w owns 16
//     keys and loops over the G q heads of its group and the q tiles that
//     can see the key tile, accumulating its DC columns of dk and dv in
//     fp32 registers, then writes [B, HKV, T, D] directly (no atomics).
//     DC = D up to D = 128; at D = 256 two blocks split the columns (DC =
//     128), each recomputing the full-D S and dP products.
// Masks (JAX semantics): causal keys t <= s + (T - S), a window keeps t >
// s + (T - S) - window, segments need q id == k id > 0; softcap * tanh(x /
// softcap) is applied to scaled scores before the mask.  A masked key gets
// p = 0 exactly in all three kernels, so a row with no visible key ends
// with l = 0 and writes o = 0 and lse = NEG_INF (-1e30, finite).

#ifndef FLASH_HEAD_DIMS
#error "define FLASH_HEAD_DIMS (the head dims to instantiate) before including"
#endif
#ifndef FLASH_PART
#define FLASH_PART 0
#endif

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>
#include <type_traits>

#include "hopper.cuh"

// Field order and types match ops/_build.py:FlashParams.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;             // forward: written; backward: unused
  const void* dout;    // backward: dO
  float* lse;          // forward: written; backward: read
  const float* delta;  // backward: rowsum(dO * O) (minus the lse cotangent)
  const int* qseg;     // null when unsegmented
  const int* kseg;
  void* dq;
  void* dk;
  void* dv;
  long long q_st[3], k_st[3], v_st[3], o_st[3], do_st[3], dq_st[3],
      dk_st[3], dv_st[3];  // (b, h, s) strides in elements
  int B, HQ, HKV, S, T, D;
  float scale, softcap;    // softcap <= 0: none
  int causal, window;      // window <= 0: none
  int dtype;               // 0 = float32, 1 = bfloat16
};

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // q rows per forward / dq block
constexpr int BK = 16 * WARPS;  // keys per dk/dv block
constexpr float NEG_INF = -1e30f;  // the TPU kernels' finite sentinel
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block can use

// keys per tile of the forward and dq kernels (fewer at D = 256, where the
// warp's 16 x D fp32 accumulator takes 128 registers a thread)
template <int D>
struct KeyTile {
  static constexpr int value = D >= 256 ? 32 : 64;
};

// q rows per inner tile of the dk/dv kernel (fewer at D = 128 to keep the
// four fp32 accumulator sets in registers)
template <int D>
struct DkvTile {
  static constexpr int value = D >= 128 ? 32 : 64;
};

// dk/dv columns one dk/dv block accumulates (two blocks split D = 256)
template <int D>
struct DkvCols {
  static constexpr int value = D >= 256 ? 128 : D;
};

// two neighbouring elements (the column pair an accumulator thread owns)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// padding of a shared-memory row: 16 bytes
template <typename E>
constexpr int pad() {
  return 16 / (int)sizeof(E);
}

// C[16 x 8] += A[16 x 16] * B[16 x 8] for one warp, in fp32 FMAs by the
// thread that owns each accumulator element.  A is row-major in shared
// memory (element (m, kk) at A[m * lda + kk]).  B is read as element (kk,
// n) at B[n * ldb + kk] ("nk": the rows of K for Q.K^T) or at B[kk * ldb +
// n] ("kn": V for P.V).  Accumulator ownership is the m16n8k16 one: lane =
// 4g + t holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <bool KN>
__device__ __forceinline__ void mma_tile(float c[4], const float* A, int lda,
                                         const float* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const float lo = A[g * lda + kk], hi = A[(g + 8) * lda + kk];
    const float b0 = KN ? B[kk * ldb + 2 * t] : B[(2 * t) * ldb + kk];
    const float b1 = KN ? B[kk * ldb + 2 * t + 1] : B[(2 * t + 1) * ldb + kk];
    c[0] = fmaf(lo, b0, c[0]);
    c[1] = fmaf(lo, b1, c[1]);
    c[2] = fmaf(hi, b0, c[2]);
    c[3] = fmaf(hi, b1, c[3]);
  }
}

// rows [0, n) of a [rows x D] global tile (row stride rs elements) into
// shared memory with row stride LD; rows [n, rows) are zero-filled so that
// no stale value (or NaN) meets a zero probability.  Every 16-byte chunk
// is one cp.async, all in flight at once; wait_tiles() waits for them (a
// __syncthreads must follow before other threads read the tile).
template <typename E, int D, int LD>
__device__ __forceinline__ void load_tile(E* dst, const E* src, long long rs,
                                          int n, int rows) {
  constexpr int VEC = 16 / (int)sizeof(E);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const E* from = r < n ? src + r * rs + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(static_cast<uint32_t>(
                       __cvta_generic_to_shared(dst + r * LD + c))),
                   "l"(from), "r"(r < n ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_tiles() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// does query s see key t (JAX kernel masks; causal offset T - S)
__device__ __forceinline__ bool visible(const FlashParams& p, int s, int t) {
  if (!p.causal) return true;
  const int qpos = s + p.T - p.S;
  return t <= qpos && (p.window <= 0 || t > qpos - p.window);
}

// score after scale and softcap; th = tanh(x / softcap) (0 without one)
__device__ __forceinline__ float score(const FlashParams& p, float raw,
                                       float& th) {
  float x = raw * p.scale;
  th = 0.f;
  if (p.softcap > 0.f) {
    th = tanhf(x / p.softcap);
    x = p.softcap * th;
  }
  return x;
}

// Narrow [lo, hi] (positions along `n_all` of the other side) to those
// whose segment id lies within [min, max] of this tile's nonzero ids
// (exact for the monotone ids packing produces, a superset otherwise).
// own_seg: this tile's ids (count n_own) in shared memory; other: the
// other side's ids in global memory.  scratch: 4 ints of shared memory.
// Every one of the block's NTHR threads calls it.
template <int NTHR = THREADS>
__device__ void narrow_by_segments(const int* own_seg, int n_own,
                                   const int* other, int& lo, int& hi,
                                   int* scratch) {
  if (threadIdx.x == 0) {
    scratch[0] = INT_MAX;  // first position kept
    scratch[1] = -1;       // last position kept
    scratch[2] = INT_MAX;  // min nonzero own id
    scratch[3] = INT_MIN;  // max nonzero own id
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_own; i += NTHR) {
    const int s = own_seg[i];
    if (s > 0) {
      atomicMin(scratch + 2, s);
      atomicMax(scratch + 3, s);
    }
  }
  __syncthreads();
  const int smin = scratch[2], smax = scratch[3];
  for (int i = lo + threadIdx.x; i <= hi; i += NTHR) {
    const int s = other[i];
    if (s >= smin && s <= smax) {
      atomicMin(scratch + 0, i);
      atomicMax(scratch + 1, i);
    }
  }
  __syncthreads();
  lo = max(lo, scratch[0]);
  hi = min(hi, scratch[1]);
  __syncthreads();  // scratch is reused by the caller's next tile
}

template <typename E, int D>
struct FwdSmem {
  static constexpr int BKT = KeyTile<D>::value;
  static constexpr int LD = D + pad<E>();
  static constexpr int PLD = BKT + pad<E>();
  static constexpr size_t bytes =
      sizeof(E) * ((size_t)(BQ + 2 * BKT) * LD + (size_t)WARPS * 16 * PLD) +
      sizeof(int) * (BQ + BKT + 4);
  static_assert(bytes <= SMEM_MAX, "forward tiles exceed shared memory");
};

template <typename E, int D>
struct DqSmem {
  static constexpr int BKT = KeyTile<D>::value;
  static constexpr int LD = D + pad<E>();
  static constexpr int PLD = BKT + pad<E>();
  static constexpr size_t bytes =
      sizeof(E) * ((size_t)(2 * BQ + 2 * BKT) * LD +
                   (size_t)WARPS * 16 * PLD) +
      sizeof(int) * (BQ + BKT + 4);
  static_assert(bytes <= SMEM_MAX, "dq tiles exceed shared memory");
};

template <typename E, int D>
struct DkvSmem {
  static constexpr int BQ2 = DkvTile<D>::value;
  static constexpr int DC = DkvCols<D>::value;
  static constexpr int LD = D + pad<E>();
  static constexpr int PLD = BQ2 + pad<E>();
  static constexpr size_t bytes =
      sizeof(E) * ((size_t)(2 * BK + 2 * BQ2) * LD +
                   (size_t)2 * WARPS * 16 * PLD) +
      sizeof(float) * 2 * BQ2 + sizeof(int) * (BQ2 + BK + 4);
  static_assert(bytes <= SMEM_MAX, "dk/dv tiles exceed shared memory");
  static_assert(D % DC == 0, "dk/dv column split must divide D");
};

// key range [lo, hi] a q tile [q0, q0 + nq) can see (causal/window
// bounds; segments narrow it further in the kernels)
__device__ __forceinline__ void key_range(const FlashParams& p, int q0, int nq,
                                          int& lo, int& hi) {
  lo = 0;
  hi = p.T - 1;
  if (p.causal) {
    const int off = p.T - p.S;
    hi = min(hi, q0 + nq - 1 + off);
    if (p.window > 0) lo = max(lo, q0 + off - p.window + 1);
  }
}

// ---------------------------------------------------------------------------
// B1, bf16: TMA ring, wgmma, warp-specialised (see the note at the top)
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// the factor of a raw score in base 2: no cap, x2 = raw scale log2(e);
// cap, raw 2 scale log2(e) / cap feeds the tanh, whose result is scaled
// by cap log2(e)
__device__ __forceinline__ float score_mul(const FlashParams& p) {
  return p.softcap > 0.f ? 2.f * p.scale * LOG2E / p.softcap
                         : p.scale * LOG2E;
}

template <int D>
struct WgFwd {
  static constexpr int BQ = 128;                  // q rows: 2 consumers x 64
  static constexpr int BKT = D >= 256 ? 64 : 128;  // keys per tile
  static constexpr int STAGES = 2;                // K/V tiles in flight
  static constexpr int THREADS = 384;             // producer + 2 consumers
  static constexpr int PANELS = D / hopper::PANEL_COLS;
  static constexpr uint32_t Q_PANEL = BQ * hopper::PANEL_ROW_BYTES;
  static constexpr uint32_t KV_PANEL = BKT * hopper::PANEL_ROW_BYTES;
  static constexpr uint32_t Q_BYTES = Q_PANEL * PANELS;
  static constexpr uint32_t KV_BYTES = KV_PANEL * PANELS;  // one K or V tile
  // q full; per stage k full, v full, k empty, v empty
  static constexpr int NBAR = 1 + 4 * STAGES;
  static constexpr size_t bytes =
      1024 /* alignment of the first panel */ + Q_BYTES +
      2 * STAGES * (size_t)KV_BYTES + 8 * NBAR + sizeof(int) * (BQ + 4);
  // registers: producer 40, consumers 232 (128 x 40 + 256 x 232 <= 64 K)
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static_assert(D % hopper::PANEL_COLS == 0, "D must be whole panels");
  static_assert(bytes <= SMEM_MAX, "wgmma forward tiles exceed shared memory");
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
                "register split exceeds the SM's file");
  // a consumer thread's arrays: O (D / 2 fp32), S (BKT / 2), P (BKT / 4)
  static_assert(D / 2 + BKT / 2 + BKT / 4 <= CONSUMER_REGS - 48,
                "consumer accumulators leave too few registers");
};

// One key tile's online-softmax step on the S accumulator, in place: the
// scaled (and capped) scores in base 2, the mask of an edge or segmented
// tile (masked: -inf, so p = 0 exactly), the running max and sum of the
// thread's two rows, and p = 2^(x - m) left in s (fp32).  alpha: the
// factor by which the rows' earlier O and l shrink.
template <bool CAP, bool EDGE, int BKT>
__device__ __forceinline__ void wg_softmax(float (&s)[BKT / 2],
                                           float (&m_run)[2],
                                           float (&l_run)[2],
                                           float (&alpha)[2],
                                           const FlashParams& p, float mul,
                                           float cap_out, int k0,
                                           const int (&qi)[2],
                                           const int (&qs)[2],
                                           const int* kseg, int t) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < BKT / 2; ++e) {
    const int r = (e >> 1) & 1;
    float x = s[e] * mul;
    if (CAP)  // cap * tanh(y / cap) in base 2; mul = 2 scale log2(e) / cap
      x = fmaf(-2.f * cap_out, hopper::rcp(hopper::ex2(x) + 1.f), cap_out);
    if (EDGE) {
      const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      bool ok = kj < p.T && visible(p, qi[r], kj);
      if (kseg != nullptr) ok = ok && qs[r] > 0 && qs[r] == kseg[kj];
      x = ok ? x : -INFINITY;
    }
    s[e] = x;
    mt[r] = fmaxf(mt[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], group_max(mt[r]));
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

template <int D>
__global__ void __launch_bounds__(WgFwd<D>::THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const FlashParams p) {
  using C = WgFwd<D>;
  using namespace hopper;
  constexpr int BQ = C::BQ, BKT = C::BKT, ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~(uintptr_t)1023);
  unsigned char* Qs = base;                   // [PANELS][BQ][64], swizzled
  unsigned char* Ks = Qs + C::Q_BYTES;        // [ST][PANELS][BKT][64]
  unsigned char* Vs = Ks + ST * C::KV_BYTES;  // [ST][PANELS][BKT][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;
  int* qseg_s = reinterpret_cast<int*>(v_empty + ST);
  int* scratch = qseg_s + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.HQ / p.HKV);
  const int q0 = qt * BQ, nq = min(BQ, p.S - q0);
  const int* kseg = p.kseg == nullptr ? nullptr : p.kseg + (long long)b * p.T;
  int lo, hi;
  key_range(p, q0, nq, lo, hi);
  if (kseg != nullptr) {
    for (int i = threadIdx.x; i < BQ; i += C::THREADS)
      qseg_s[i] = i < nq ? p.qseg[(long long)b * p.S + q0 + i] : 0;
    narrow_by_segments<C::THREADS>(qseg_s, BQ, kseg, lo, hi, scratch);
  }
  // key tiles [kt_lo, kt_lo + n_tiles) of BKT keys, aligned to BKT
  const int kt_lo = lo / BKT;
  const int n_tiles = hi >= lo ? hi / BKT - kt_lo + 1 : 0;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2 * 128);  // every consumer thread arrives
      mbar_init(&v_empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int pn = 0; pn < C::PANELS; ++pn)
        tma_load_4d(Qs + pn * C::Q_PANEL, &tm_q, q_full, pn * PANEL_COLS, q0,
                    h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % ST, k0 = (kt_lo + i) * BKT;
        const uint32_t free_phase = ((i / ST) & 1) ^ 1;  // round 0 passes
        unsigned char* kd = Ks + st * C::KV_BYTES;
        unsigned char* vd = Vs + st * C::KV_BYTES;
        mbar_wait(&k_empty[st], free_phase);
        mbar_arrive_expect_tx(&k_full[st], C::KV_BYTES);
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load_4d(kd + pn * C::KV_PANEL, &tm_k, &k_full[st],
                      pn * PANEL_COLS, k0, hk, b);
        mbar_wait(&v_empty[st], free_phase);
        mbar_arrive_expect_tx(&v_full[st], C::KV_BYTES);
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load_4d(vd + pn * C::KV_PANEL, &tm_v, &v_full[st],
                      pn * PANEL_COLS, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int c = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int off = p.T - p.S;
    const int r0 = q0 + 64 * c;                // the warpgroup's first q row
    const int r_last = min(r0 + 63, p.S - 1);  // its last valid row
    const int qi[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    int qs[2] = {0, 0};
    if (kseg != nullptr)
      for (int r = 0; r < 2; ++r) qs[r] = qseg_s[qi[r] - q0];
    const bool cap = p.softcap > 0.f;
    const float mul = score_mul(p), cap_out = p.softcap * LOG2E;
    const uint32_t q_addr = smem_u32(Qs) + 64 * c * PANEL_ROW_BYTES;

    // the softmax step for tile i, by its mask class
    auto softmax = [&](float (&s)[BKT / 2], float (&m_run)[2],
                       float (&l_run)[2], float (&alpha)[2], int i) {
      const int k0 = (kt_lo + i) * BKT;
      const bool edge =
          kseg != nullptr || k0 + BKT > p.T ||
          (p.causal && (k0 + BKT - 1 > r0 + off ||
                        (p.window > 0 && k0 <= r_last + off - p.window)));
      if (edge) {
        if (cap)
          wg_softmax<true, true, BKT>(s, m_run, l_run, alpha, p, mul, cap_out,
                                      k0, qi, qs, kseg, t);
        else
          wg_softmax<false, true, BKT>(s, m_run, l_run, alpha, p, mul,
                                       cap_out, k0, qi, qs, kseg, t);
      } else {
        if (cap)
          wg_softmax<true, false, BKT>(s, m_run, l_run, alpha, p, mul,
                                       cap_out, k0, qi, qs, kseg, t);
        else
          wg_softmax<false, false, BKT>(s, m_run, l_run, alpha, p, mul,
                                        cap_out, k0, qi, qs, kseg, t);
      }
    };
    // S = Q K^T of tile i over D, 16 columns a step (issued, not waited)
    auto issue_qk = [&](float (&s)[BKT / 2], int i) {
      const uint32_t k_addr = smem_u32(Ks + (i % ST) * C::KV_BYTES);
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
      const uint32_t v_addr = smem_u32(Vs + (i % ST) * C::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    desc_mn_major(v_addr + kk * 16 * PANEL_ROW_BYTES,
                                  C::KV_PANEL),
                    1);
      wgmma_commit();
    };

    // P of a tile (in s after its softmax) as the A fragments of P V, 16
    // keys each: the accumulator layout packs in place
    auto pack_p = [](const float (&s)[BKT / 2],
                     uint32_t (&pa)[BKT / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          pa[kk][f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
    };

    // Ping-pong: the two consumers take turns to issue their products
    // (named barrier 1 + c is "consumer c's turn"), so that one's softmax
    // runs while the other's products hold the tensor cores.  Both walk
    // every tile of the block (a tile none of a consumer's rows can see is
    // fully masked), so their turns pair up; consumer 0 goes first.
    auto my_turn = [&] { named_barrier_sync(1 + c, 256); };
    auto your_turn = [&] { named_barrier_arrive(2 - c, 256); };

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
    if (c == 1) your_turn();
    mbar_wait(q_full, 0);

    if (n_tiles > 0) {
      // Software pipeline: while tile i's softmax runs on the CUDA cores,
      // tile i - 1's P V runs on the tensor cores.
      float s[BKT / 2];
      uint32_t pa[BKT / 16][4];  // P of the tile whose P V is next
      float alpha[2];
      mbar_wait(&k_full[0], 0);
      fence_regs(s);
      my_turn();
      wgmma_fence();
      issue_qk(s, 0);
      your_turn();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&k_empty[0]);
      softmax(s, m_run, l_run, alpha, 0);
      pack_p(s, pa);

      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % ST, sp = (i - 1) % ST;
        mbar_wait(&k_full[st], (i / ST) & 1);
        mbar_wait(&v_full[sp], ((i - 1) / ST) & 1);
        fence_regs(s);
        fence_regs(o);
        my_turn();
        wgmma_fence();
        issue_qk(s, i);
        issue_pv(o, pa, i - 1);
        your_turn();
        wgmma_wait<1>();  // S of tile i is in; P V of tile i - 1 runs on
        fence_regs(s);
        mbar_arrive(&k_empty[st]);
        softmax(s, m_run, l_run, alpha, i);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&v_empty[sp]);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
        pack_p(s, pa);
      }
      const int il = n_tiles - 1;
      mbar_wait(&v_full[il % ST], (il / ST) & 1);
      fence_regs(o);
      my_turn();
      wgmma_fence();
      issue_pv(o, pa, il);
      if (c == 0) your_turn();  // consumer 1 had the first extra turn
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&v_empty[il % ST]);
    } else if (c == 0) {
      my_turn();  // take consumer 1's opening turn
    }

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_st[0] +
                        h * p.o_st[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = group_sum(l_run[r]);
      if (qi[r] >= p.S) continue;
      const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(og + qi[r] * p.o_st[2] + 8 * j + 2 * t, o[4 * j + 2 * r] * inv,
               o[4 * j + 2 * r + 1] * inv);
      if (t == 0)  // natural-log lse from the base-2 statistics
        p.lse[((long long)b * p.HQ + h) * p.S + qi[r]] =
            l > 0.f ? (m_run[r] + log2f(l)) * 0.6931471805599453f : NEG_INF;
    }
  }
}

// ---------------------------------------------------------------------------
// B2 and B3, bf16: TMA ring, wgmma, warp-specialised (see the note at the top)
// ---------------------------------------------------------------------------

// p = exp(x - lse) of one raw score in base 2 (lse2 = lse log2(e)), and
// dfac = 1 - tanh^2 under the softcap (1 without); mul = score_mul, cap_out
// = cap log2(e)
template <bool CAP>
__device__ __forceinline__ float bwd_prob(float raw, float mul, float cap_out,
                                          float lse2, float& dfac) {
  if (CAP) {
    const float th = fmaf(-2.f, hopper::rcp(hopper::ex2(raw * mul) + 1.f), 1.f);
    dfac = fmaf(-th, th, 1.f);
    return hopper::ex2(fmaf(cap_out, th, -lse2));
  }
  dfac = 1.f;
  return hopper::ex2(fmaf(raw, mul, -lse2));
}

// dS = P (1 - t^2) (dP - delta) scale of a q-row tile in place in s (rows
// = q, columns = keys; dq): the mask of an edge tile (masked: p = 0
// exactly), lse2 and delta of the thread's two rows
template <bool CAP, bool EDGE, int N>
__device__ __forceinline__ void dq_scores(float (&s)[N / 2],
                                          const float (&dp)[N / 2],
                                          const FlashParams& p, float mul,
                                          float cap_out,
                                          const float (&lse2)[2],
                                          const float (&dlt)[2], int k0,
                                          const int (&qi)[2],
                                          const int (&qs)[2],
                                          const int* kseg, int t) {
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int r = (e >> 1) & 1;
    float f;
    float pr = bwd_prob<CAP>(s[e], mul, cap_out, lse2[r], f);
    if (EDGE) {
      const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      bool ok = kj < p.T && visible(p, qi[r], kj);
      if (kseg != nullptr) ok = ok && qs[r] > 0 && qs[r] == kseg[kj];
      pr = ok ? pr : 0.f;
    }
    s[e] = pr * f * (dp[e] - dlt[r]) * p.scale;
  }
}

// P^T of the score pair (x0, x1) of key row kj and q columns qi, qi + 1
// (dk/dv), in place, with its 1 - t^2 factors; lse: the columns' lse; the
// mask of an edge tile (q rows past S read another head's statistics)
template <bool CAP, bool EDGE>
__device__ __forceinline__ void dkv_pair(float& x0, float& x1, float& f0,
                                         float& f1, const FlashParams& p,
                                         float mul, float cap_out,
                                         float2 lse, int qi, int kj, int ks,
                                         const int* qseg) {
  x0 = bwd_prob<CAP>(x0, mul, cap_out, lse.x * LOG2E, f0);
  x1 = bwd_prob<CAP>(x1, mul, cap_out, lse.y * LOG2E, f1);
  if (EDGE) {
    bool ok0 = qi < p.S && visible(p, qi, kj);
    bool ok1 = qi + 1 < p.S && visible(p, qi + 1, kj);
    if (qseg != nullptr) {
      const int s0 = qi < p.S ? qseg[qi] : 0;
      const int s1 = qi + 1 < p.S ? qseg[qi + 1] : 0;
      ok0 = ok0 && s0 > 0 && s0 == ks;
      ok1 = ok1 && s1 > 0 && s1 == ks;
    }
    x0 = ok0 ? x0 : 0.f;
    x1 = ok1 ? x1 : 0.f;
  }
}

// P^T and dS^T = P^T (1 - t^2) (dP^T - delta) scale of a key-row tile
// (rows = keys, columns = q), packed to bf16 as RS A fragments of 16 q
// columns each (pa, da) in one pass, so each score's registers are free
// once its pair is packed; lse and delta of the tile's q rows come from
// shared memory
template <bool CAP, bool EDGE, int N>
__device__ __forceinline__ void dkv_grads(
    float (&s)[N / 2], const float (&dp)[N / 2], uint32_t (&pa)[N / 16][4],
    uint32_t (&da)[N / 16][4], const FlashParams& p, float mul,
    float cap_out, const float* lse_t, const float* delta_t, int q0,
    const int (&kj)[2], const int (&ks)[2], const int* qseg, int t) {
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const int r = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * t;
    float f0, f1;
    dkv_pair<CAP, EDGE>(s[e], s[e + 1], f0, f1, p, mul, cap_out,
                        make_float2(lse_t[col], lse_t[col + 1]),
                        q0 + col, kj[r], ks[r], qseg);
    const float2 dl = make_float2(delta_t[col], delta_t[col + 1]);
    pa[e >> 3][(e >> 1) & 3] = hopper::pack_bf16(s[e], s[e + 1]);
    da[e >> 3][(e >> 1) & 3] =
        hopper::pack_bf16(s[e] * f0 * (dp[e] - dl.x) * p.scale,
                          s[e + 1] * f1 * (dp[e + 1] - dl.y) * p.scale);
  }
}

// D = 256, consumer 0: P^T and P^T (1 - t^2) of its S^T tile into the two
// hand-over panels (row = key row in the block)
template <bool CAP, bool EDGE, int N>
__device__ __forceinline__ void dkv_probs_to_panels(
    float (&s)[N / 2], unsigned char* Pp, unsigned char* Dp,
    const FlashParams& p, float mul, float cap_out, const float* lse_t,
    int q0, const int (&kl)[2], const int (&kj)[2], const int (&ks)[2],
    const int* qseg, int t) {
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const int r = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * t;
    float f0, f1;
    dkv_pair<CAP, EDGE>(s[e], s[e + 1], f0, f1, p, mul, cap_out,
                        make_float2(lse_t[col], lse_t[col + 1]),
                        q0 + col, kj[r], ks[r], qseg);
    hopper::st_panel(Pp, kl[r], col, hopper::pack_bf16(s[e], s[e + 1]));
    hopper::st_panel(Dp, kl[r], col,
                     hopper::pack_bf16(s[e] * f0, s[e + 1] * f1));
  }
}

template <int D>
struct WgDq {
  static constexpr int BQ = 128;                   // q rows: 2 consumers x 64
  static constexpr int BKT = D >= 256 ? 32 : 64;   // keys per tile
  static constexpr int STAGES = 3;                 // K/V tiles in flight
  static constexpr int THREADS = 384;              // producer + 2 consumers
  static constexpr int PANELS = D / hopper::PANEL_COLS;
  static constexpr uint32_t Q_PANEL = BQ * hopper::PANEL_ROW_BYTES;
  static constexpr uint32_t KV_PANEL = BKT * hopper::PANEL_ROW_BYTES;
  static constexpr uint32_t Q_BYTES = Q_PANEL * PANELS;     // Q or dO
  static constexpr uint32_t KV_BYTES = KV_PANEL * PANELS;   // one K or V tile
  static constexpr int NBAR = 1 + 2 * STAGES;  // q/dO full; stage full, empty
  static constexpr size_t bytes = 1024 + 2 * (size_t)Q_BYTES +
                                  2 * STAGES * (size_t)KV_BYTES + 8 * NBAR +
                                  sizeof(int) * (BQ + 4);
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static_assert(D % hopper::PANEL_COLS == 0, "D must be whole panels");
  static_assert(bytes <= SMEM_MAX, "wgmma dq tiles exceed shared memory");
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
                "register split exceeds the SM's file");
  // a consumer thread's arrays: dQ (D / 2 fp32), S and dP (BKT / 2 each),
  // dS fragments (BKT / 4)
  static_assert(D / 2 + BKT + BKT / 4 <= CONSUMER_REGS - 48,
                "consumer accumulators leave too few registers");
};

// B2: one block of three warpgroups per 128 q rows of one head.  The
// producer TMA-loads the block's Q and dO once, then streams the K and V
// tiles of its key range through the ring; each consumer owns 64 q rows:
// S = Q K^T and dP = dO V^T (SS, K-major), dS = P (dP - delta) (1 - t^2)
// scale in registers, packed in place as the A fragments of dQ += dS K
// (RS, K MN-major).  Tile i's dQ product runs while tile i + 1's S and dP
// are issued; the two consumers run apart, so one's elementwise pass runs
// under the other's products.
template <int D>
__global__ void __launch_bounds__(WgDq<D>::THREADS, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const FlashParams p) {
  using C = WgDq<D>;
  using namespace hopper;
  constexpr int BQ = C::BQ, BKT = C::BKT, ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~(uintptr_t)1023);
  unsigned char* Qs = base;                   // [PANELS][BQ][64], swizzled
  unsigned char* dOs = Qs + C::Q_BYTES;       // [PANELS][BQ][64]
  unsigned char* Ks = dOs + C::Q_BYTES;       // [ST][PANELS][BKT][64]
  unsigned char* Vs = Ks + ST * C::KV_BYTES;  // [ST][PANELS][BKT][64]
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(Vs + ST * C::KV_BYTES);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + ST;
  int* qseg_s = reinterpret_cast<int*>(empty + ST);
  int* scratch = qseg_s + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.HQ / p.HKV);
  const int q0 = qt * BQ, nq = min(BQ, p.S - q0);
  const int* kseg = p.kseg == nullptr ? nullptr : p.kseg + (long long)b * p.T;
  int lo, hi;
  key_range(p, q0, nq, lo, hi);
  if (kseg != nullptr) {
    for (int i = threadIdx.x; i < BQ; i += C::THREADS)
      qseg_s[i] = i < nq ? p.qseg[(long long)b * p.S + q0 + i] : 0;
    narrow_by_segments<C::THREADS>(qseg_s, BQ, kseg, lo, hi, scratch);
  }
  const int kt_lo = lo / BKT;
  const int n_tiles = hi >= lo ? hi / BKT - kt_lo + 1 : 0;
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(qdo_full, 2 * C::Q_BYTES);
      for (int pn = 0; pn < C::PANELS; ++pn) {
        tma_load_4d(Qs + pn * C::Q_PANEL, &tm_q, qdo_full, pn * PANEL_COLS,
                    q0, h, b);
        tma_load_4d(dOs + pn * C::Q_PANEL, &tm_do, qdo_full, pn * PANEL_COLS,
                    q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % ST, k0 = (kt_lo + i) * BKT;
        mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);  // round 0 passes
        mbar_arrive_expect_tx(&full[st], 2 * C::KV_BYTES);
        for (int pn = 0; pn < C::PANELS; ++pn) {
          tma_load_4d(Ks + st * C::KV_BYTES + pn * C::KV_PANEL, &tm_k,
                      &full[st], pn * PANEL_COLS, k0, hk, b);
          tma_load_4d(Vs + st * C::KV_BYTES + pn * C::KV_PANEL, &tm_v,
                      &full[st], pn * PANEL_COLS, k0, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int c = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int off = p.T - p.S;
    const int r0 = q0 + 64 * c;                // the warpgroup's first q row
    const int r_last = min(r0 + 63, p.S - 1);  // its last valid row
    const int qi[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    // rows past S read lse = delta = 0 and zero Q and dO: their dS is 0
    float lse2[2], dlt[2];
    int qs[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = ((long long)b * p.HQ + h) * p.S + qi[r];
      lse2[r] = qi[r] < p.S ? p.lse[row] * LOG2E : 0.f;
      dlt[r] = qi[r] < p.S ? p.delta[row] : 0.f;
      if (kseg != nullptr) qs[r] = qseg_s[qi[r] - q0];
    }
    const bool cap = p.softcap > 0.f;
    const float mul = score_mul(p), cap_out = p.softcap * LOG2E;
    const uint32_t q_addr = smem_u32(Qs) + 64 * c * PANEL_ROW_BYTES;
    const uint32_t do_addr = smem_u32(dOs) + 64 * c * PANEL_ROW_BYTES;

    float dq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
    uint32_t da[BKT / 16][4];  // dS of the tile whose dQ product is in flight
    if (n_tiles > 0) mbar_wait(qdo_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % ST, k0 = (kt_lo + i) * BKT;
      const uint32_t k_addr = smem_u32(Ks + st * C::KV_BYTES);
      const uint32_t v_addr = smem_u32(Vs + st * C::KV_BYTES);
      float s[BKT / 2], dp[BKT / 2];
      mbar_wait(&full[st], (i / ST) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKT>(
            s, desc_k_major(q_addr + (kk / 4) * C::Q_PANEL + (kk % 4) * 32),
            desc_k_major(k_addr + (kk / 4) * C::KV_PANEL + (kk % 4) * 32),
            kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKT>(
            dp, desc_k_major(do_addr + (kk / 4) * C::Q_PANEL + (kk % 4) * 32),
            desc_k_major(v_addr + (kk / 4) * C::KV_PANEL + (kk % 4) * 32),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();  // S, dP and the previous tile's dQ product are in
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dq);
      if (i > 0) mbar_arrive(&empty[(i - 1) % ST]);

      // a key tile is interior (no mask code) or edge (causal diagonal,
      // the window's left edge, keys past T, segments)
      const bool edge =
          kseg != nullptr || k0 + BKT > p.T ||
          (p.causal && (k0 + BKT - 1 > r0 + off ||
                        (p.window > 0 && k0 <= r_last + off - p.window)));
      if (cap) {
        if (edge)
          dq_scores<true, true, BKT>(s, dp, p, mul, cap_out, lse2, dlt, k0,
                                     qi, qs, kseg, t);
        else
          dq_scores<true, false, BKT>(s, dp, p, mul, cap_out, lse2, dlt, k0,
                                      qi, qs, kseg, t);
      } else {
        if (edge)
          dq_scores<false, true, BKT>(s, dp, p, mul, cap_out, lse2, dlt, k0,
                                      qi, qs, kseg, t);
        else
          dq_scores<false, false, BKT>(s, dp, p, mul, cap_out, lse2, dlt, k0,
                                       qi, qs, kseg, t);
      }
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          da[kk][f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
        wgmma_rs<D>(dq, da[kk],
                    desc_mn_major(k_addr + kk * 16 * PANEL_ROW_BYTES,
                                  C::KV_PANEL),
                    1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq);
    if (n_tiles > 0) mbar_arrive(&empty[(n_tiles - 1) % ST]);

    __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_st[0] +
                         h * p.dq_st[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= p.S) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(dqg + qi[r] * p.dq_st[2] + 8 * j + 2 * t, dq[4 * j + 2 * r],
               dq[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
struct WgDkv {
  // D = 256: the two consumers split one block of 64 keys by role (S^T
  // and P, then dP^T and dS, handed over through swizzled panels), then
  // by column half for the dV and dK products; below 256 each consumer
  // owns 64 of the block's 128 keys and all of D
  static constexpr bool SPLIT = D >= 256;
  static constexpr int BK = SPLIT ? 64 : 128;  // keys per block
  static constexpr int BQ = 64;                // q rows per tile
  static constexpr int STAGES = SPLIT ? 2 : 3;  // Q/dO tiles in flight
  static constexpr int THREADS = 384;
  static constexpr int PANELS = D / hopper::PANEL_COLS;
  static constexpr uint32_t K_PANEL = BK * hopper::PANEL_ROW_BYTES;
  static constexpr uint32_t Q_PANEL = BQ * hopper::PANEL_ROW_BYTES;
  static constexpr uint32_t K_BYTES = K_PANEL * PANELS;  // K or V
  static constexpr uint32_t Q_BYTES = Q_PANEL * PANELS;  // one Q or dO tile
  // per stage, D = 256: the P^T panel and the dS^T panel (64 keys x BQ)
  static constexpr uint32_t HAND_BYTES = SPLIT ? 2 * K_PANEL : 0;
  // per stage: the tile's lse and delta rows (fp32, by TMA).  A box must
  // start 16-byte aligned, so it starts at the multiple of 4 at or below
  // the tile's first row and holds 4 values more; each lands in a
  // 128-byte-aligned slot
  static constexpr int ROW_BOX = BQ + 4;
  static constexpr int ROW_SLOT = 96;  // floats
  static constexpr int NBAR = 1 + 2 * STAGES;  // K/V full; stage full, empty
  static constexpr size_t bytes =
      1024 + 2 * (size_t)K_BYTES +
      STAGES * (2 * (size_t)Q_BYTES + HAND_BYTES + 2 * 4 * ROW_SLOT) +
      8 * NBAR + sizeof(int) * (BK + 6);
  static_assert(ROW_SLOT >= ROW_BOX && ROW_SLOT * 4 % 128 == 0,
                "an lse/delta slot holds a box, 128-byte aligned");
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static_assert(D % hopper::PANEL_COLS == 0, "D must be whole panels");
  static_assert(BQ == hopper::PANEL_COLS, "a hand-over panel is 64 q wide");
  static_assert(bytes <= SMEM_MAX, "wgmma dk/dv tiles exceed shared memory");
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
                "register split exceeds the SM's file");
  // a consumer thread's arrays: dK and dV (D / 2 fp32 each, D / 4 split),
  // S^T and dP^T (BQ / 2 each; one of them split)
  static_assert((SPLIT ? D / 2 + BQ / 2 : D + BQ) <= CONSUMER_REGS - 32,
                "consumer accumulators leave too few registers");
};

// B3: one block of three warpgroups per key tile of one kv head.  The
// producer TMA-loads the block's K and V once, then streams the Q and dO
// tiles (with their lse and delta rows) of every q head of the group and
// every q tile that can see the key tile through the ring.  D < 256: each
// consumer owns 64 keys; S^T = K Q^T and dP^T = V dO^T (SS, K-major, keys
// as the M rows), P^T and dS^T in registers, packed in place as the A
// fragments of dV += P^T dO and dK += dS^T Q (RS, dO and Q MN-major).
// D = 256: consumer 0 computes S^T and P^T, consumer 1 dP^T and dS^T (P^T
// and P^T (1 - t^2) come to it through two swizzled panels, named barriers
// order the hand-over), then each takes one column half of dV and dK (SS,
// A from the panels).  dK and dV are summed over the group's q heads in
// registers and written once: deterministic, no atomics.
template <int D>
__global__ void __launch_bounds__(WgDkv<D>::THREADS, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_lse,
                           const __grid_constant__ CUtensorMap tm_delta,
                           const FlashParams p) {
  using C = WgDkv<D>;
  using namespace hopper;
  constexpr int BK = C::BK, BQ = C::BQ, ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~(uintptr_t)1023);
  unsigned char* Ks = base;                    // [PANELS][BK][64], swizzled
  unsigned char* Vs = Ks + C::K_BYTES;         // [PANELS][BK][64]
  unsigned char* Qs = Vs + C::K_BYTES;         // [ST][PANELS][BQ][64]
  unsigned char* dOs = Qs + ST * C::Q_BYTES;   // [ST][PANELS][BQ][64]
  unsigned char* Hs = dOs + ST * C::Q_BYTES;   // [ST][P^T, dS^T panels]
  // [ST][ROW_SLOT] each
  float* lse_s = reinterpret_cast<float*>(Hs + ST * C::HAND_BYTES);
  float* delta_s = lse_s + ST * C::ROW_SLOT;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + ST * C::ROW_SLOT);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;
  int* kseg_s = reinterpret_cast<int*>(empty + ST);
  int* scratch = kseg_s + BK;  // narrow_by_segments' 4, then the q tiles' 2

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.HQ / p.HKV;
  const int k0 = kt * BK, nk = min(BK, p.T - k0);
  const int* qseg = p.qseg == nullptr ? nullptr : p.qseg + (long long)b * p.S;
  // q rows [lo, hi] that can see a key of this tile
  int lo = 0, hi = p.S - 1;
  const int off = p.T - p.S;
  if (p.causal) {
    lo = max(lo, k0 - off);
    if (p.window > 0) hi = min(hi, k0 + nk - 1 - off + p.window - 1);
  }
  if (qseg != nullptr) {
    for (int i = threadIdx.x; i < BK; i += C::THREADS)
      kseg_s[i] = i < nk ? p.kseg[(long long)b * p.T + k0 + i] : 0;
    narrow_by_segments<C::THREADS>(kseg_s, BK, qseg, lo, hi, scratch);
  }
  // q tiles [qt_lo, qt_lo + n_qt) of BQ rows, aligned to BQ, per q head;
  // each role reads them back from shared memory, so no register holds
  // them across the split (the producer keeps few)
  if (threadIdx.x == 0) {
    scratch[4] = lo / BQ;
    scratch[5] = hi >= lo ? hi / BQ - lo / BQ + 1 : 0;
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    const int qt_lo = scratch[4], n_qt = scratch[5], n_iter = G * n_qt;
    if (threadIdx.x == 0 && n_iter > 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::K_BYTES);
      for (int pn = 0; pn < C::PANELS; ++pn) {
        tma_load_4d(Ks + pn * C::K_PANEL, &tm_k, kv_full, pn * PANEL_COLS, k0,
                    hk, b);
        tma_load_4d(Vs + pn * C::K_PANEL, &tm_v, kv_full, pn * PANEL_COLS, k0,
                    hk, b);
      }
      for (int i = 0; i < n_iter; ++i) {
        const int st = i % ST, h = hk * G + i / n_qt;
        const int q0 = (qt_lo + i % n_qt) * BQ;
        mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);  // round 0 passes
        mbar_arrive_expect_tx(&full[st],
                              2 * C::Q_BYTES + 2 * 4 * C::ROW_BOX);
        for (int pn = 0; pn < C::PANELS; ++pn) {
          tma_load_4d(Qs + st * C::Q_BYTES + pn * C::Q_PANEL, &tm_q,
                      &full[st], pn * PANEL_COLS, q0, h, b);
          tma_load_4d(dOs + st * C::Q_BYTES + pn * C::Q_PANEL, &tm_do,
                      &full[st], pn * PANEL_COLS, q0, h, b);
        }
        // the rows' lse and delta, from the aligned element at or below
        // the first; rows past S read the next head's (or zeros at the
        // end), which the mask of the tile's edge class drops
        const int row = ((b * p.HQ + h) * p.S + q0) & ~3;
        tma_load_flat(lse_s + st * C::ROW_SLOT, &tm_lse, &full[st], row);
        tma_load_flat(delta_s + st * C::ROW_SLOT, &tm_delta, &full[st], row);
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int qt_lo = scratch[4], n_qt = scratch[5], n_iter = G * n_qt;
    const int c = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // the warpgroup's first key, and the thread's two key rows in the tile
    const int kc0 = C::SPLIT ? k0 : k0 + 64 * c;
    const int kl[2] = {kc0 - k0 + 16 * warp + g, kc0 - k0 + 16 * warp + g + 8};
    const int kj[2] = {k0 + kl[0], k0 + kl[1]};
    int ks[2] = {0, 0};
    if (qseg != nullptr)
      for (int r = 0; r < 2; ++r) ks[r] = kseg_s[kl[r]];
    const bool cap = p.softcap > 0.f;
    const float mul = score_mul(p), cap_out = p.softcap * LOG2E;
    constexpr int NACC = C::SPLIT ? D / 4 : D / 2;  // dK, dV columns / 2
    float dk[NACC], dv[NACC];
#pragma unroll
    for (int e = 0; e < NACC; ++e) dk[e] = dv[e] = 0.f;
    if (n_iter > 0) mbar_wait(kv_full, 0);

    for (int i = 0; i < n_iter; ++i) {
      const int st = i % ST;
      const int q0 = (qt_lo + i % n_qt) * BQ;
      // the tile's first row within its slot
      const int sh = ((b * p.HQ + hk * G + i / n_qt) * p.S + q0) & 3;
      const float* lse_t = lse_s + st * C::ROW_SLOT + sh;
      const float* delta_t = delta_s + st * C::ROW_SLOT + sh;
      const uint32_t q_addr = smem_u32(Qs + st * C::Q_BYTES);
      const uint32_t do_addr = smem_u32(dOs + st * C::Q_BYTES);
      // a q tile is interior to the consumer's keys (no mask code) or edge
      // (causal diagonal, the window's edge, q rows past S, segments);
      // keys past T need no mask (a key row's dK and dV depend on that
      // row alone, and those rows are not stored)
      const bool edge =
          qseg != nullptr || q0 + BQ > p.S ||
          (p.causal && (kc0 + 63 > q0 + off ||
                        (p.window > 0 && kc0 <= q0 + BQ - 1 + off - p.window)));
      mbar_wait(&full[st], (i / ST) & 1);
      if constexpr (!C::SPLIT) {
        const uint32_t k_addr =
            opaque(smem_u32(Ks) + 64 * c * PANEL_ROW_BYTES);
        const uint32_t v_addr =
            opaque(smem_u32(Vs) + 64 * c * PANEL_ROW_BYTES);
        float s[BQ / 2], dp[BQ / 2];
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BQ>(
              s, desc_k_major(k_addr + (kk / 4) * C::K_PANEL + (kk % 4) * 32),
              desc_k_major(q_addr + (kk / 4) * C::Q_PANEL + (kk % 4) * 32),
              kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BQ>(
              dp, desc_k_major(v_addr + (kk / 4) * C::K_PANEL + (kk % 4) * 32),
              desc_k_major(do_addr + (kk / 4) * C::Q_PANEL + (kk % 4) * 32),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // P^T and dS^T packed in place as the A fragments, 16 q rows each
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        if (cap) {
          if (edge)
            dkv_grads<true, true, BQ>(s, dp, pa, da, p, mul, cap_out, lse_t,
                                      delta_t, q0, kj, ks, qseg, t);
          else
            dkv_grads<true, false, BQ>(s, dp, pa, da, p, mul, cap_out,
                                       lse_t, delta_t, q0, kj, ks, qseg, t);
        } else {
          if (edge)
            dkv_grads<false, true, BQ>(s, dp, pa, da, p, mul, cap_out,
                                       lse_t, delta_t, q0, kj, ks, qseg, t);
          else
            dkv_grads<false, false, BQ>(s, dp, pa, da, p, mul, cap_out,
                                        lse_t, delta_t, q0, kj, ks, qseg, t);
        }
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<D>(dv, pa[kk],
                      desc_mn_major(do_addr + kk * 16 * PANEL_ROW_BYTES,
                                    C::Q_PANEL),
                      1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<D>(dk, da[kk],
                      desc_mn_major(q_addr + kk * 16 * PANEL_ROW_BYTES,
                                    C::Q_PANEL),
                      1);
        wgmma_commit();
      } else {
        // consumer 0: S^T = K Q^T; consumer 1: dP^T = V dO^T
        const uint32_t a_addr = smem_u32(c == 0 ? Ks : Vs);
        const uint32_t b_addr = c == 0 ? q_addr : do_addr;
        unsigned char* Pp = Hs + st * C::HAND_BYTES;  // P^T, bf16
        unsigned char* Dp = Pp + C::K_PANEL;          // P^T (1-t^2), then dS^T
        float sc[BQ / 2];
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BQ>(
              sc, desc_k_major(a_addr + (kk / 4) * C::K_PANEL + (kk % 4) * 32),
              desc_k_major(b_addr + (kk / 4) * C::Q_PANEL + (kk % 4) * 32),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (c == 0) {
          if (cap) {
            if (edge)
              dkv_probs_to_panels<true, true, BQ>(sc, Pp, Dp, p, mul, cap_out,
                                                  lse_t, q0, kl, kj, ks, qseg,
                                                  t);
            else
              dkv_probs_to_panels<true, false, BQ>(sc, Pp, Dp, p, mul,
                                                   cap_out, lse_t, q0, kl, kj,
                                                   ks, qseg, t);
          } else {
            if (edge)
              dkv_probs_to_panels<false, true, BQ>(sc, Pp, Dp, p, mul,
                                                   cap_out, lse_t, q0, kl, kj,
                                                   ks, qseg, t);
            else
              dkv_probs_to_panels<false, false, BQ>(sc, Pp, Dp, p, mul,
                                                    cap_out, lse_t, q0, kl,
                                                    kj, ks, qseg, t);
          }
          fence_proxy_async();
          named_barrier_arrive(1, 256);  // P^T is in
        } else {
          named_barrier_sync(1, 256);
#pragma unroll
          for (int e = 0; e < BQ / 2; e += 2) {
            const int row = kl[(e >> 1) & 1], col = 8 * (e >> 2) + 2 * t;
            const float2 dl = make_float2(delta_t[col], delta_t[col + 1]);
            const float2 pf = ld_panel(Dp, row, col);
            st_panel(Dp, row, col,
                     pack_bf16(pf.x * (sc[e] - dl.x) * p.scale,
                               pf.y * (sc[e + 1] - dl.y) * p.scale));
          }
          fence_proxy_async();
        }
        named_barrier_sync(2, 256);  // dS^T is in
        // dV[:, half] += P^T dO[:, half], dK[:, half] += dS^T Q[:, half]
        const uint32_t half = 2 * c * C::Q_PANEL;
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_ss_mn<128>(
              dv, desc_k_major(smem_u32(Pp) + kk * 32),
              desc_mn_major(do_addr + half + kk * 16 * PANEL_ROW_BYTES,
                            C::Q_PANEL),
              1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_ss_mn<128>(
              dk, desc_k_major(smem_u32(Dp) + kk * 32),
              desc_mn_major(q_addr + half + kk * 16 * PANEL_ROW_BYTES,
                            C::Q_PANEL),
              1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(&empty[st]);
    }

    // dK and dV of the consumer's keys (all columns, or its half at 256)
    const int col0 = C::SPLIT ? 128 * c : 0;
    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_st[0] +
                         hk * p.dk_st[1] + col0;
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_st[0] +
                         hk * p.dv_st[1] + col0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kj[r] >= p.T) continue;
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        store2(dkg + kj[r] * p.dk_st[2] + 8 * j + 2 * t, dk[4 * j + 2 * r],
               dk[4 * j + 2 * r + 1]);
        store2(dvg + kj[r] * p.dv_st[2] + 8 * j + 2 * t, dv[4 * j + 2 * r],
               dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B1, fp32: the mma.sync forward with fp32 FMAs
// ---------------------------------------------------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const FlashParams p) {
  using SM = FwdSmem<E, D>;
  constexpr int LD = SM::LD, PLD = SM::PLD, BKT = SM::BKT, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);
  E* Ks = Qs + BQ * LD;
  E* Vs = Ks + BKT * LD;
  E* Ps = Vs + BKT * LD;
  int* qseg_s = reinterpret_cast<int*>(Ps + WARPS * 16 * PLD);
  int* kseg_s = qseg_s + BQ;
  int* scratch = kseg_s + BKT;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.HQ / p.HKV);
  const int q0 = qt * BQ, nq = min(BQ, p.S - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool seg = p.qseg != nullptr;

  const E* qg = static_cast<const E*>(p.q) + b * p.q_st[0] + h * p.q_st[1] +
                q0 * p.q_st[2];
  const E* kg = static_cast<const E*>(p.k) + b * p.k_st[0] + hk * p.k_st[1];
  const E* vg = static_cast<const E*>(p.v) + b * p.v_st[0] + hk * p.v_st[1];
  load_tile<E, D, LD>(Qs, qg, p.q_st[2], nq, BQ);
  int lo, hi;
  key_range(p, q0, nq, lo, hi);
  if (seg) {
    for (int i = threadIdx.x; i < BQ; i += THREADS)
      qseg_s[i] = i < nq ? p.qseg[(long long)b * p.S + q0 + i] : 0;
    narrow_by_segments(qseg_s, BQ, p.kseg + (long long)b * p.T, lo, hi,
                       scratch);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // block-local rows
  E* Pw = Ps + warp * 16 * PLD;

  for (int k0 = lo; k0 <= hi; k0 += BKT) {
    const int nk = min(BKT, hi - k0 + 1);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<E, D, LD>(Ks, kg + k0 * p.k_st[2], p.k_st[2], nk, BKT);
    load_tile<E, D, LD>(Vs, vg + k0 * p.v_st[2], p.v_st[2], nk, BKT);
    if (seg)
      for (int i = threadIdx.x; i < BKT; i += THREADS)
        kseg_s[i] = i < nk ? p.kseg[(long long)b * p.T + k0 + i] : 0;
    wait_tiles();
    __syncthreads();

    float s[BKT / 8][4];
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j)
        mma_tile<false>(s[j], Qs + warp * 16 * LD + kk, LD,
                        Ks + j * 8 * LD + kk, LD);

    // scale, cap, mask (masked -> -inf marker); running max per row
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * 8 + 2 * t + (e & 1);
        const int qi = q0 + rl[r], kj = k0 + col;
        float th;
        const float x = score(p, s[j][e], th);
        bool ok = col < nk && rl[r] < nq && visible(p, qi, kj);
        if (seg) ok = ok && qseg_s[rl[r]] > 0 && qseg_s[rl[r]] == kseg_s[col];
        s[j][e] = ok ? x : -INFINITY;
        m_tile[r] = fmaxf(m_tile[r], s[j][e]);
      }
    float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], group_max(m_tile[r]));
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pr[e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m_run[e >> 1]);
      lsum[0] += pr[0] + pr[1];
      lsum[1] += pr[2] + pr[3];
      store2(Pw + g * PLD + j * 8 + 2 * t, pr[0], pr[1]);
      store2(Pw + (g + 8) * PLD + j * 8 + 2 * t, pr[2], pr[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + group_sum(lsum[r]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 16)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_tile<true>(o[n], Pw + kk, PLD, Vs + kk * LD + n * 8, LD);
    __syncwarp();
  }

  wait_tiles();  // no copy outlives the block
  E* og = static_cast<E*>(p.o) + b * p.o_st[0] + h * p.o_st[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rl[r] >= nq) continue;
    const int qi = q0 + rl[r];
    const float l = l_run[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2(og + qi * p.o_st[2] + n * 8 + 2 * t, o[n][2 * r] * inv,
             o[n][2 * r + 1] * inv);
    if (t == 0)
      p.lse[((long long)b * p.HQ + h) * p.S + qi] =
          m_run[r] + logf(l == 0.f ? 1.f : l);
  }
}

// ---------------------------------------------------------------------------
// B2: dq
// ---------------------------------------------------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(THREADS)
    flash_dq_kernel(const FlashParams p) {
  using SM = DqSmem<E, D>;
  constexpr int LD = SM::LD, PLD = SM::PLD, BKT = SM::BKT, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);
  E* dOs = Qs + BQ * LD;
  E* Ks = dOs + BQ * LD;
  E* Vs = Ks + BKT * LD;
  E* Ws = Vs + BKT * LD;
  int* qseg_s = reinterpret_cast<int*>(Ws + WARPS * 16 * PLD);
  int* kseg_s = qseg_s + BQ;
  int* scratch = kseg_s + BKT;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.HQ / p.HKV);
  const int q0 = qt * BQ, nq = min(BQ, p.S - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool seg = p.qseg != nullptr;

  load_tile<E, D, LD>(Qs,
                      static_cast<const E*>(p.q) + b * p.q_st[0] +
                          h * p.q_st[1] + q0 * p.q_st[2],
                      p.q_st[2], nq, BQ);
  load_tile<E, D, LD>(dOs,
                      static_cast<const E*>(p.dout) + b * p.do_st[0] +
                          h * p.do_st[1] + q0 * p.do_st[2],
                      p.do_st[2], nq, BQ);
  const E* kg = static_cast<const E*>(p.k) + b * p.k_st[0] + hk * p.k_st[1];
  const E* vg = static_cast<const E*>(p.v) + b * p.v_st[0] + hk * p.v_st[1];
  int lo, hi;
  key_range(p, q0, nq, lo, hi);
  if (seg) {
    for (int i = threadIdx.x; i < BQ; i += THREADS)
      qseg_s[i] = i < nq ? p.qseg[(long long)b * p.S + q0 + i] : 0;
    narrow_by_segments(qseg_s, BQ, p.kseg + (long long)b * p.T, lo, hi,
                       scratch);
  }
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};
  const long long row0 = ((long long)b * p.HQ + h) * p.S + q0;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = rl[r] < nq ? p.lse[row0 + rl[r]] : 0.f;
    delta_r[r] = rl[r] < nq ? p.delta[row0 + rl[r]] : 0.f;
  }

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  E* Ww = Ws + warp * 16 * PLD;

  for (int k0 = lo; k0 <= hi; k0 += BKT) {
    const int nk = min(BKT, hi - k0 + 1);
    __syncthreads();
    load_tile<E, D, LD>(Ks, kg + k0 * p.k_st[2], p.k_st[2], nk, BKT);
    load_tile<E, D, LD>(Vs, vg + k0 * p.v_st[2], p.v_st[2], nk, BKT);
    if (seg)
      for (int i = threadIdx.x; i < BKT; i += THREADS)
        kseg_s[i] = i < nk ? p.kseg[(long long)b * p.T + k0 + i] : 0;
    wait_tiles();
    __syncthreads();

    float s[BKT / 8][4], dp[BKT / 8][4];
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j) {
        mma_tile<false>(s[j], Qs + warp * 16 * LD + kk, LD,
                        Ks + j * 8 * LD + kk, LD);
        mma_tile<false>(dp[j], dOs + warp * 16 * LD + kk, LD,
                        Vs + j * 8 * LD + kk, LD);
      }
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * 8 + 2 * t + (e & 1);
        float th;
        const float x = score(p, s[j][e], th);
        bool ok = col < nk && rl[r] < nq && visible(p, q0 + rl[r], k0 + col);
        if (seg) ok = ok && qseg_s[rl[r]] > 0 && qseg_s[rl[r]] == kseg_s[col];
        const float pr = ok ? expf(x - lse_r[r]) : 0.f;
        float d = pr * (dp[j][e] - delta_r[r]);
        if (p.softcap > 0.f) d *= 1.f - th * th;
        ds[e] = d * p.scale;
      }
      store2(Ww + g * PLD + j * 8 + 2 * t, ds[0], ds[1]);
      store2(Ww + (g + 8) * PLD + j * 8 + 2 * t, ds[2], ds[3]);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 16)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_tile<true>(dq[n], Ww + kk, PLD, Ks + kk * LD + n * 8, LD);
    __syncwarp();
  }

  wait_tiles();  // no copy outlives the block
  E* dqg = static_cast<E*>(p.dq) + b * p.dq_st[0] + h * p.dq_st[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rl[r] >= nq) continue;
    const int qi = q0 + rl[r];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2(dqg + qi * p.dq_st[2] + n * 8 + 2 * t, dq[n][2 * r],
             dq[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// B3: dk, dv
// ---------------------------------------------------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_kernel(const FlashParams p) {
  using SM = DkvSmem<E, D>;
  constexpr int LD = SM::LD, PLD = SM::PLD, BQ2 = SM::BQ2, DC = SM::DC,
                NT = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Ks = reinterpret_cast<E*>(smem_raw);
  E* Vs = Ks + BK * LD;
  E* Qs = Vs + BK * LD;
  E* dOs = Qs + BQ2 * LD;
  E* Pbuf = dOs + BQ2 * LD;          // WARPS x 16 x PLD, p^T
  E* Dbuf = Pbuf + WARPS * 16 * PLD; // WARPS x 16 x PLD, dS^T
  float* lse_s = reinterpret_cast<float*>(Dbuf + WARPS * 16 * PLD);
  float* delta_s = lse_s + BQ2;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ2);
  int* kseg_s = qseg_s + BQ2;
  int* scratch = kseg_s + BK;

  const int kt = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / (D / DC);
  const int c0 = (blockIdx.y % (D / DC)) * DC;  // first dk/dv column owned
  const int G = p.HQ / p.HKV;
  const int k0 = kt * BK, nk = min(BK, p.T - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool seg = p.qseg != nullptr;

  load_tile<E, D, LD>(Ks,
                      static_cast<const E*>(p.k) + b * p.k_st[0] +
                          hk * p.k_st[1] + k0 * p.k_st[2],
                      p.k_st[2], nk, BK);
  load_tile<E, D, LD>(Vs,
                      static_cast<const E*>(p.v) + b * p.v_st[0] +
                          hk * p.v_st[1] + k0 * p.v_st[2],
                      p.v_st[2], nk, BK);
  // q rows [lo, hi] that can see a key of this tile
  int lo = 0, hi = p.S - 1;
  if (p.causal) {
    const int off = p.T - p.S;
    lo = max(lo, k0 - off);
    if (p.window > 0) hi = min(hi, k0 + nk - 1 - off + p.window - 1);
  }
  if (seg) {
    for (int i = threadIdx.x; i < BK; i += THREADS)
      kseg_s[i] = i < nk ? p.kseg[(long long)b * p.T + k0 + i] : 0;
    narrow_by_segments(kseg_s, BK, p.qseg + (long long)b * p.S, lo, hi,
                       scratch);
  }
  const int kl[2] = {warp * 16 + g, warp * 16 + g + 8};  // block-local keys

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  E* Pw = Pbuf + warp * 16 * PLD;
  E* Dw = Dbuf + warp * 16 * PLD;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const E* qg = static_cast<const E*>(p.q) + b * p.q_st[0] + h * p.q_st[1];
    const E* dog =
        static_cast<const E*>(p.dout) + b * p.do_st[0] + h * p.do_st[1];
    const long long rows = ((long long)b * p.HQ + h) * p.S;
    for (int q0 = lo; q0 <= hi; q0 += BQ2) {
      const int nq = min(BQ2, hi - q0 + 1);
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<E, D, LD>(Qs, qg + q0 * p.q_st[2], p.q_st[2], nq, BQ2);
      load_tile<E, D, LD>(dOs, dog + q0 * p.do_st[2], p.do_st[2], nq, BQ2);
      for (int i = threadIdx.x; i < BQ2; i += THREADS) {
        lse_s[i] = i < nq ? p.lse[rows + q0 + i] : 0.f;
        delta_s[i] = i < nq ? p.delta[rows + q0 + i] : 0.f;
        if (seg) qseg_s[i] = i < nq ? p.qseg[(long long)b * p.S + q0 + i] : 0;
      }
      wait_tiles();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
      float s[BQ2 / 8][4], dp[BQ2 / 8][4];
#pragma unroll
      for (int j = 0; j < BQ2 / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16)
#pragma unroll
        for (int j = 0; j < BQ2 / 8; ++j) {
          mma_tile<false>(s[j], Ks + warp * 16 * LD + kk, LD,
                          Qs + j * 8 * LD + kk, LD);
          mma_tile<false>(dp[j], Vs + warp * 16 * LD + kk, LD,
                          dOs + j * 8 * LD + kk, LD);
        }
#pragma unroll
      for (int j = 0; j < BQ2 / 8; ++j) {
        float pr[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = j * 8 + 2 * t + (e & 1);
          float th;
          const float x = score(p, s[j][e], th);
          bool ok = col < nq && kl[r] < nk && visible(p, q0 + col, k0 + kl[r]);
          if (seg) ok = ok && qseg_s[col] > 0 && qseg_s[col] == kseg_s[kl[r]];
          pr[e] = ok ? expf(x - lse_s[col]) : 0.f;
          float d = pr[e] * (dp[j][e] - delta_s[col]);
          if (p.softcap > 0.f) d *= 1.f - th * th;
          ds[e] = d * p.scale;
        }
        store2(Pw + g * PLD + j * 8 + 2 * t, pr[0], pr[1]);
        store2(Pw + (g + 8) * PLD + j * 8 + 2 * t, pr[2], pr[3]);
        store2(Dw + g * PLD + j * 8 + 2 * t, ds[0], ds[1]);
        store2(Dw + (g + 8) * PLD + j * 8 + 2 * t, ds[2], ds[3]);
      }
      __syncwarp();
      // dV += P^T dO, dK += dS^T Q (contraction over the tile's q rows),
      // for the block's columns [c0, c0 + DC)
#pragma unroll
      for (int kk = 0; kk < BQ2; kk += 16)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_tile<true>(dv[n], Pw + kk, PLD, dOs + kk * LD + c0 + n * 8, LD);
          mma_tile<true>(dk[n], Dw + kk, PLD, Qs + kk * LD + c0 + n * 8, LD);
        }
      __syncwarp();
    }
  }

  wait_tiles();  // no copy outlives the block
  E* dkg = static_cast<E*>(p.dk) + b * p.dk_st[0] + hk * p.dk_st[1];
  E* dvg = static_cast<E*>(p.dv) + b * p.dv_st[0] + hk * p.dv_st[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kl[r] >= nk) continue;
    const int kj = k0 + kl[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      store2(dkg + kj * p.dk_st[2] + c0 + n * 8 + 2 * t, dk[n][2 * r],
             dk[n][2 * r + 1]);
      store2(dvg + kj * p.dv_st[2] + c0 + n * 8 + 2 * t, dv[n][2 * r],
             dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum Which { FWD = 0, DQ = 1, DKV = 2 };

// one dynamic-shared-memory attribute call per kernel instantiation
template <typename Kernel>
int allow_smem(Kernel* kernel, size_t smem, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

// tensor maps over the operands of kernel C (C::maps(): which rows each
// box holds), encoded per call (they hold the pointers and strides); then
// the warp-specialised kernel
template <int D, int W>
int launch_wgmma(const FlashParams& p, cudaStream_t stream) {
  static bool attr_set = false;
  CUtensorMap tq, tk, tv, tdo;
  int e;
  if constexpr (W == FWD) {
    using C = WgFwd<D>;
    if ((e = hopper::encode_rows(&tq, p.q, D, p.S, p.HQ, p.B, p.q_st,
                                 C::BQ)) ||
        (e = hopper::encode_rows(&tk, p.k, D, p.T, p.HKV, p.B, p.k_st,
                                 C::BKT)) ||
        (e = hopper::encode_rows(&tv, p.v, D, p.T, p.HKV, p.B, p.v_st,
                                 C::BKT)))
      return e;
    if ((e = allow_smem(flash_fwd_wgmma_kernel<D>, C::bytes, attr_set)))
      return e;
    const dim3 grid((p.S + C::BQ - 1) / C::BQ, p.HQ, p.B);
    flash_fwd_wgmma_kernel<D><<<grid, C::THREADS, C::bytes, stream>>>(tq, tk,
                                                                      tv, p);
  } else {
    // dq: Q/dO boxes of the block's q rows, K/V boxes of one key tile;
    // dk/dv: K/V boxes of the block's keys, Q/dO boxes of one q tile
    using C = std::conditional_t<W == DQ, WgDq<D>, WgDkv<D>>;
    constexpr int QROWS = C::BQ;
    constexpr int KROWS = W == DQ ? WgDq<D>::BKT : WgDkv<D>::BK;
    if ((e = hopper::encode_rows(&tq, p.q, D, p.S, p.HQ, p.B, p.q_st,
                                 QROWS)) ||
        (e = hopper::encode_rows(&tdo, p.dout, D, p.S, p.HQ, p.B, p.do_st,
                                 QROWS)) ||
        (e = hopper::encode_rows(&tk, p.k, D, p.T, p.HKV, p.B, p.k_st,
                                 KROWS)) ||
        (e = hopper::encode_rows(&tv, p.v, D, p.T, p.HKV, p.B, p.v_st,
                                 KROWS)))
      return e;
    if constexpr (W == DQ) {
      if ((e = allow_smem(flash_dq_wgmma_kernel<D>, C::bytes, attr_set)))
        return e;
      const dim3 grid((p.S + C::BQ - 1) / C::BQ, p.HQ, p.B);
      flash_dq_wgmma_kernel<D><<<grid, C::THREADS, C::bytes, stream>>>(
          tq, tdo, tk, tv, p);
    } else {
      if ((e = allow_smem(flash_dkv_wgmma_kernel<D>, C::bytes, attr_set)))
        return e;
      CUtensorMap tl, td;
      const long long rows = (long long)p.B * p.HQ * p.S;
      if ((e = hopper::encode_flat_f32(&tl, p.lse, rows, C::ROW_BOX)) ||
          (e = hopper::encode_flat_f32(&td, p.delta, rows, C::ROW_BOX)))
        return e;
      const dim3 grid((p.T + C::BK - 1) / C::BK, p.HKV, p.B);
      flash_dkv_wgmma_kernel<D><<<grid, C::THREADS, C::bytes, stream>>>(
          tq, tdo, tk, tv, tl, td, p);
    }
  }
  return (int)cudaGetLastError();
}

// bf16: the wgmma kernels; fp32: the mma.sync ones
template <typename E, int D, int W>
int launch(const FlashParams& p, cudaStream_t stream) {
  static bool attr_set = false;
  int e = 0;
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    return launch_wgmma<D, W>(p, stream);
  } else if constexpr (W == FWD) {
    constexpr size_t smem = FwdSmem<E, D>::bytes;
    if ((e = allow_smem(flash_fwd_kernel<E, D>, smem, attr_set))) return e;
    const dim3 grid((p.S + BQ - 1) / BQ, p.HQ, p.B);
    flash_fwd_kernel<E, D><<<grid, THREADS, smem, stream>>>(p);
  } else if constexpr (W == DQ) {
    constexpr size_t smem = DqSmem<E, D>::bytes;
    if ((e = allow_smem(flash_dq_kernel<E, D>, smem, attr_set))) return e;
    const dim3 grid((p.S + BQ - 1) / BQ, p.HQ, p.B);
    flash_dq_kernel<E, D><<<grid, THREADS, smem, stream>>>(p);
  } else {
    constexpr size_t smem = DkvSmem<E, D>::bytes;
    if ((e = allow_smem(flash_dkv_kernel<E, D>, smem, attr_set))) return e;
    const dim3 grid((p.T + BK - 1) / BK, p.HKV * (D / DkvSmem<E, D>::DC),
                    p.B);
    flash_dkv_kernel<E, D><<<grid, THREADS, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// kernel W at the (dtype, D) of *p, for the head dims Ds this library was
// built with (-1 for any other)
template <int W, int... Ds>
int dispatch(const FlashParams* p, void* stream) {
  if (p == nullptr || p->B < 1 || p->S < 1 || p->T < 1 || p->HKV < 1 ||
      p->HQ % p->HKV != 0 || (p->qseg == nullptr) != (p->kseg == nullptr) ||
      (p->dtype != 0 && p->dtype != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  ((p->D == Ds ? (rc = p->dtype == 0 ? launch<float, Ds, W>(*p, s)
                                     : launch<__nv_bfloat16, Ds, W>(*p, s))
               : 0),
   ...);
  return rc;
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// after the launch (0 = launched), -1 for an argument the kernel does not
// take (a head dim outside FLASH_HEAD_DIMS among them), or, for bf16
// (the wgmma kernels), 999 when the driver has no tensor-map encoder and
// 1000 + the CUresult when it refuses a map.  Pointers and every (b, h, s)
// stride must be 16-byte aligned.
#if FLASH_PART == 0 || FLASH_PART == 1
extern "C" int flash_attention_fwd(const FlashParams* p, void* stream) {
  return dispatch<FWD, FLASH_HEAD_DIMS>(p, stream);
}
#endif
#if FLASH_PART == 0 || FLASH_PART == 2
extern "C" int flash_attention_dq(const FlashParams* p, void* stream) {
  return dispatch<DQ, FLASH_HEAD_DIMS>(p, stream);
}
#endif
#if FLASH_PART == 0 || FLASH_PART == 3
extern "C" int flash_attention_dkv(const FlashParams* p, void* stream) {
  return dispatch<DKV, FLASH_HEAD_DIMS>(p, stream);
}
#endif
// sizeof(FlashParams), checked by the Python binding against its ctypes
// mirror before the first launch
#if FLASH_PART == 0 || FLASH_PART == 1
extern "C" int flash_params_size() { return (int)sizeof(FlashParams); }
// dynamic shared memory of the bf16 (wgmma) kernel `which` (0 forward, 1
// dq, 2 dk/dv) at head dim D (-1 for a D this library was not built with)
template <int... Ds>
int wgmma_smem_bytes(int which, int D) {
  int bytes = -1;
  ((D == Ds ? (bytes = which == FWD  ? (int)WgFwd<Ds>::bytes
                       : which == DQ ? (int)WgDq<Ds>::bytes
                                     : (int)WgDkv<Ds>::bytes)
            : 0),
   ...);
  return bytes;
}
extern "C" int flash_wgmma_smem_bytes(int which, int D) {
  return wgmma_smem_bytes<FLASH_HEAD_DIMS>(which, D);
}
#endif
