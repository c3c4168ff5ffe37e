// Flash-attention forward, dq and dk/dv kernels for Hopper (sm_90a), plain C
// interface.  This header holds the kernels; each library source defines
// FLASH_HEAD_DIMS (the head dims it instantiates) and includes it:
// flash_attention.cu builds D = 64 and 128, flash_attention_d256.cu D = 256,
// so the two nvcc runs go in parallel.
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
// B1 in fp32 (flash_fwd_kernel), B2 and B3: mma.sync m16n8k16 (bf16 in,
// fp32 accumulate; fp32 inputs take the same code with the product done in
// fp32 FMAs by the thread that owns each accumulator element) with
// fragments loaded by ldmatrix; tiles of 64 rows staged by cp.async in
// shared memory (rows padded by 16 bytes so fragment loads are
// bank-conflict free); each block walks only the tiles its causal, window
// and segment bounds leave (the TPU kernels' pl.when skips become loop
// bounds); the heaviest causal q tiles are scheduled first.  wgmma has no
// fp32 mode, and TF32 would not hold fp32's tolerance, so the fp32
// forward stays on this kernel.
//
// Work layout:
//   bf16 forward: grid (ceil(S / 128), HQ, B), 384 threads, as above;
//   fp32 forward, dq: grid (ceil(S / 64), HQ, B), 4 warps; warp w owns q
//     rows [16w, 16w + 16) of the block's tile and loops over key tiles of
//     64 (32 at D = 256: a warp's 16 x 256 fp32 accumulator alone is 128
//     registers a thread, so the score tile is halved);
//   dk/dv: grid (ceil(T / 64), HKV * D / DC, B), 4 warps; warp w owns 16
//     keys and loops over the G q heads of its group and the q tiles that
//     can see the key tile, accumulating its DC columns of dk and dv in
//     fp32 registers, then writes [B, HKV, T, D] directly: no per-q-head
//     partials, no atomics, so the result is deterministic.  DC = D up to
//     D = 128; at D = 256 dk and dv together would need 256 accumulator
//     registers a thread, so two blocks split the columns (DC = 128), each
//     recomputing the full-D S and dP products (1.5x the kernel's flops).
// Masks (JAX semantics): causal keys t <= s + (T - S), a window keeps t >
// s + (T - S) - window, segments need q id == k id > 0; softcap * tanh(x /
// softcap) is applied to scaled scores before the mask.  A masked key gets
// p = 0 exactly in all three kernels, so a row with no visible key ends
// with l = 0 and writes o = 0 and lse = NEG_INF (-1e30, finite).

#ifndef FLASH_HEAD_DIMS
#error "define FLASH_HEAD_DIMS (the head dims to instantiate) before including"
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

// C[16 x 8] += A[16 x 16] * B[16 x 8] for one warp.  A is row-major in
// shared memory (element (m, kk) at A[m * lda + kk]).  B is read as
// element (kk, n) at B[n * ldb + kk] ("nk": the rows of K for Q.K^T) or
// at B[kk * ldb + n] ("kn": V for P.V).  Accumulator ownership is the
// m16n8k16 one: lane = 4g + t holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).  The bf16 fragments come from shared memory by
// ldmatrix (one instruction for A, one for B; .trans for the "kn" B), so
// every row address is 16-byte aligned: lda, ldb and the column offsets
// are multiples of 8 elements.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool KN>
__device__ __forceinline__ void mma_tile(float c[4], const __nv_bfloat16* A,
                                         int lda, const __nv_bfloat16* B,
                                         int ldb) {
  const int lane = threadIdx.x & 31;
  uint32_t a0, a1, a2, a3, b0, b1;
  // A: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15) -> a0 a1 a2 a3
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
      : "r"(smem_addr(A + (lane & 15) * lda + (lane >> 4) * 8))
      : "memory");
  if (KN) {
    // rows kk = 0-7 and 8-15 of a row-major [kk][n] tile, transposed
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(b0), "=r"(b1)
        : "r"(smem_addr(B + (lane & 15) * ldb))
        : "memory");
  } else {
    // rows n = 0-7 of a row-major [n][kk] tile, cols kk 0-7 and 8-15
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(b0), "=r"(b1)
        : "r"(smem_addr(B + (lane & 7) * ldb + ((lane >> 3) & 1) * 8))
        : "memory");
  }
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

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
  for (int i = threadIdx.x; i < n_own; i += THREADS) {
    const int s = own_seg[i];
    if (s > 0) {
      atomicMin(scratch + 2, s);
      atomicMax(scratch + 3, s);
    }
  }
  __syncthreads();
  const int smin = scratch[2], smax = scratch[3];
  for (int i = lo + threadIdx.x; i <= hi; i += THREADS) {
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
    constexpr float LOG2E = 1.4426950408889634f;
    const bool cap = p.softcap > 0.f;
    // no cap: x2 = raw * scale log2(e); cap: raw * 2 scale log2(e) / cap
    // feeds the tanh, whose result is scaled by cap log2(e)
    const float mul = cap ? 2.f * p.scale * LOG2E / p.softcap
                          : p.scale * LOG2E;
    const float cap_out = p.softcap * LOG2E;
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

// the bf16 forward: tensor maps over q, k and v (encoded per call: they
// hold the pointers and strides), then the warp-specialised kernel
template <int D>
int launch_fwd_wgmma(const FlashParams& p, cudaStream_t stream) {
  using C = WgFwd<D>;
  static bool attr_set = false;
  CUtensorMap tq, tk, tv;
  int e;
  if ((e = hopper::encode_rows(&tq, p.q, D, p.S, p.HQ, p.B, p.q_st, C::BQ)) ||
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
  return (int)cudaGetLastError();
}

template <typename E, int D, int W>
int launch(const FlashParams& p, cudaStream_t stream) {
  static bool attr_set = false;
  int e = 0;
  if constexpr (W == FWD && std::is_same<E, __nv_bfloat16>::value) {
    return launch_fwd_wgmma<D>(p, stream);
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
// take (a head dim outside FLASH_HEAD_DIMS among them), or, for the bf16
// forward, 999 when the driver has no tensor-map encoder and 1000 + the
// CUresult when it refuses a map.  Pointers and
// every (b, h, s) stride must be 16-byte aligned.
extern "C" int flash_attention_fwd(const FlashParams* p, void* stream) {
  return dispatch<FWD, FLASH_HEAD_DIMS>(p, stream);
}
extern "C" int flash_attention_dq(const FlashParams* p, void* stream) {
  return dispatch<DQ, FLASH_HEAD_DIMS>(p, stream);
}
extern "C" int flash_attention_dkv(const FlashParams* p, void* stream) {
  return dispatch<DKV, FLASH_HEAD_DIMS>(p, stream);
}
// sizeof(FlashParams), checked by the Python binding against its ctypes
// mirror before the first launch
extern "C" int flash_params_size() { return (int)sizeof(FlashParams); }
// dynamic shared memory of the bf16 forward at head dim D (-1 for a D this
// library was not built with)
template <int... Ds>
int fwd_smem_bytes(int D) {
  int bytes = -1;
  ((D == Ds ? (bytes = (int)WgFwd<Ds>::bytes) : 0), ...);
  return bytes;
}
extern "C" int flash_fwd_smem_bytes(int D) {
  return fwd_smem_bytes<FLASH_HEAD_DIMS>(D);
}
