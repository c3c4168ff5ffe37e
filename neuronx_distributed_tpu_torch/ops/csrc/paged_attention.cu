// Paged-attention decode kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel neuronx_distributed_tpu/ops/paged_attention.py:
// _paged_kernel (pallas_call in _paged_attention_impl): attention of
// q [B, S, NQ, D] over one layer's KV page pool [NP, page, NKV, D], walking
// each slot's block table [B, PP] in device memory, without gathering the
// chain into a contiguous copy.  Both pool layouts of the TPU kernel:
// pages in q's type, or int8 pages with one fp32 (scale, zero) per
// physical page for K and for V, dequantized inside the kernel (the TPU
// kernel's int8 branch, :211-221).
//
// What bounds it on the H100: bytes.  Every K/V page a slot needs is read
// once from device memory (3.35 TB/s on the H100 SXM); a decode step does
// about 4 * G * S flops per K/V element read, far below the ~295 flop/byte
// at which the tensor cores become the limit.  What the design does about
// it: an int8 pool halves the K/V bytes of a bf16 one (a 16-byte load
// carries 16 codes) plus 16 bytes of params per page; one block serves ALL
// G * S query rows of one kv head (G = NQ / NKV
// grouped query heads times S query positions), so each K/V element is
// loaded from device memory into shared memory once and used by every row;
// the block walks only the slot's needed key range [lo, hi] (left of the
// sliding window, below kv_start and past the last written position are
// never read); a tile's K/V loads are 16-byte vectors all issued before
// any is used, so their latencies overlap; and split-K spreads one chain
// over several blocks so that enough blocks are in flight to hide latency.
//
// Layout of the work:
//   grid  = (B * NKV, split_k, ceil(G * S / MAX_ROWS)), block = D threads;
//   query row r of kv head h is (s = r / G, q head h * G + r % G), the
//   row order of the TPU kernel;
//   each tile of TK consecutive key positions is staged in shared memory as
//   fp32 (the physical page of every key comes from the block table,
//   clamped to NP - 1), scores and p.V are plain fp32 FMAs, the softmax is
//   online in fp32 with one warp per row and one lane per key.
// int8 pages: each key's page params are read once per tile beside its
//   page offset, and a code c becomes (c + 128) * scale + zero in fp32,
//   multiply and add rounded separately (no FMA contraction) and then
//   rounded once to q's type, which is what the plain version
//   (kvcache.quant.dequantize_page to q.dtype) computes: kernel and plain
//   version attend the same K/V values.
// Masks: row s sees keys in [kv_start, off + s], narrowed to the last
// `window` positions when window > 0; softcap * tanh(score / softcap) is
// applied before the mask; masked keys get p = 0 exactly.
// Edge cases: a parked slot (off >= PP * page) and a row that sees no key
// end with l = 0 and write exact zeros.
// split_k == 1 normalises and writes out [B, S, NQ, D] in the input type;
// split_k > 1 writes unnormalised fp32 partials acc [B, NKV, sk, G*S, D],
// m and l [B, NKV, sk, G*S] to a workspace, and a second kernel merges them
// by logsumexp weight into out (the TPU kernel's epilogue, :407-420).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TK = 32;        // key positions per tile: one warp lane each
constexpr int MAX_ROWS = 16;  // query rows per block
constexpr float NEG_INF = -1e30f;  // the TPU kernel's finite sentinel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// x rounded to Elem and back: the plain version's dequant to q.dtype
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of elements -> floats in shared memory
__device__ __forceinline__ void unpack(const uint4& u, float* dst, float) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = f[e];
}
__device__ __forceinline__ void unpack(const uint4& u, float* dst,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    dst[2 * e] = f.x;
    dst[2 * e + 1] = f.y;
  }
}

// 16 int8 codes -> dequantized floats in shared memory
template <typename Elem>
__device__ __forceinline__ void dequant(const uint4& u, float* dst,
                                        float scale, float zero) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int e = 0; e < 16; ++e)
    dst[e] = round_to(
        __fadd_rn(__fmul_rn(static_cast<float>(c[e]) + 128.f, scale), zero),
        Elem());
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)MAX_ROWS * D     // q rows
                          + (size_t)TK * (D + 1)   // K tile, padded rows
                          + (size_t)TK * D         // V tile
                          + (size_t)MAX_ROWS * TK  // scores, then p
                          + 3 * MAX_ROWS           // m, l, alpha per row
                          + 4 * TK)                // int8 page params per key
         + sizeof(long long) * TK;                 // element offset per key
}

// KV is the pool's element type: Elem (pages in q's type) or int8_t (page
// params in k_scale .. v_zero, [NP] fp32 each; unused otherwise)
template <typename Elem, typename KV, int D>
__global__ void __launch_bounds__(D) paged_attention_kernel(
    const Elem* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ k_zero, const float* __restrict__ v_scale,
    const float* __restrict__ v_zero, const int* __restrict__ block_table,
    const int* __restrict__ cache_offset, const int* __restrict__ kv_start,
    Elem* __restrict__ out, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int S, int NQ,
    int NKV, int NP, int page, int PP, float sm_scale, int window,
    float softcap, int split_k) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int VEC = 16 / sizeof(KV);    // elements per 16-byte load
  constexpr int CHUNKS = TK * D / VEC;     // 16-byte loads per K (or V) tile
  constexpr int KS = D + 1;  // padded K stride: the score loop is conflict-free
  extern __shared__ __align__(16) float smem[];
  const int G = NQ / NKV;
  const int rows = G * S;
  const int b = blockIdx.x / NKV;
  const int h = blockIdx.x % NKV;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * MAX_ROWS;
  const int nrows = min(MAX_ROWS, rows - r0);
  const int tid = threadIdx.x;  // blockDim.x == D: thread tid owns column tid
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NWARPS = D / 32;
  const int T = PP * page;

  float* q_s = smem;
  float* k_s = q_s + MAX_ROWS * D;
  float* v_s = k_s + TK * KS;
  float* p_s = v_s + TK * D;
  float* m_s = p_s + MAX_ROWS * TK;
  float* l_s = m_s + MAX_ROWS;
  float* a_s = l_s + MAX_ROWS;
  float* ks_s = a_s + MAX_ROWS;  // per key of the tile: its page's params
  float* kz_s = ks_s + TK;
  float* vs_s = kz_s + TK;
  float* vz_s = vs_s + TK;
  long long* base_s = reinterpret_cast<long long*>(vz_s + TK);

  const int off = cache_offset[b];
  const int start = kv_start[b];

  // this block's share of the slot's needed key range [lo, hi]
  int lo = 0, hi = -1;
  if (off < T) {
    hi = min(off + S - 1, T - 1);
    lo = max(start, 0);
    if (window > 0) lo = max(lo, off - window + 1);
    const int n = hi - lo + 1;
    if (n > 0) {
      const int per = ((n + split_k - 1) / split_k + TK - 1) / TK * TK;
      const int s_lo = lo + split * per;
      hi = min(hi, s_lo + per - 1);
      lo = s_lo;
    }
  }

  float acc[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.f;
  if (tid < MAX_ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  for (int r = 0; r < nrows; ++r) {
    const int s = (r0 + r) / G, g = (r0 + r) % G;
    q_s[r * D + tid] =
        to_float(q[((size_t)(b * S + s) * NQ + h * G + g) * D + tid]);
  }

  for (int t0 = lo; t0 <= hi; t0 += TK) {
    const int nk = min(TK, hi - t0 + 1);
    if (tid < nk) {  // one block-table lookup per key of the tile
      const int pos = t0 + tid;
      int phys = block_table[(size_t)b * PP + pos / page];
      phys = min(max(phys, 0), NP - 1);
      base_s[tid] =
          (((long long)phys * page + pos % page) * NKV + h) * (long long)D;
      if constexpr (QUANT) {
        ks_s[tid] = k_scale[phys];
        kz_s[tid] = k_zero[phys];
        vs_s[tid] = v_scale[phys];
        vz_s[tid] = v_zero[phys];
      }
    }
    __syncthreads();
    // issue every 16-byte K/V load of the tile, then unpack to fp32
    uint4 kr[CHUNKS / D], vr[CHUNKS / D];
#pragma unroll
    for (int i = 0; i < CHUNKS / D; ++i) {
      const int c = tid + i * D;
      const int j = c / (D / VEC), d0 = (c % (D / VEC)) * VEC;
      if (j < nk) {
        kr[i] = *reinterpret_cast<const uint4*>(k_pages + base_s[j] + d0);
        vr[i] = *reinterpret_cast<const uint4*>(v_pages + base_s[j] + d0);
      }
    }
#pragma unroll
    for (int i = 0; i < CHUNKS / D; ++i) {
      const int c = tid + i * D;
      const int j = c / (D / VEC), d0 = (c % (D / VEC)) * VEC;
      if (j < nk) {
        float tmp[VEC];
        if constexpr (QUANT) {
          dequant<Elem>(kr[i], tmp, ks_s[j], kz_s[j]);
          dequant<Elem>(vr[i], v_s + j * D + d0, vs_s[j], vz_s[j]);
        } else {
          unpack(kr[i], tmp, Elem());
          unpack(vr[i], v_s + j * D + d0, Elem());
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) k_s[j * KS + d0 + e] = tmp[e];
      }
    }
    __syncthreads();

    // scores; masked (and past-the-tile) keys are marked -inf
    for (int i = tid; i < nrows * TK; i += D) {
      const int r = i / TK, j = i % TK;
      float sc = -INFINITY;
      if (j < nk) {
        const float* qr = q_s + r * D;
        const float* kk = k_s + j * KS;
        float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int d = 0; d < D; d += 4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d4[e] = fmaf(qr[d + e], kk[d + e], d4[e]);
        }
        sc = ((d4[0] + d4[1]) + (d4[2] + d4[3])) * sm_scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        const int pos = t0 + j;
        const int qpos = off + (r0 + r) / G;
        const bool ok = pos <= qpos && pos >= start &&
                        (window <= 0 || pos > qpos - window);
        if (!ok) sc = -INFINITY;
      }
      p_s[r * TK + j] = sc;
    }
    __syncthreads();

    // online softmax, one warp per row, one lane per key
    for (int r = warp; r < nrows; r += NWARPS) {
      const float x = p_s[r * TK + lane];
      const bool masked = x == -INFINITY;
      const float xs = masked ? NEG_INF : x;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(xs));
      const float alpha = expf(m_prev - m_new);
      const float p = masked ? 0.f : expf(xs - m_new);
      const float l_new = alpha * l_s[r] + warp_sum(p);
      p_s[r * TK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < nrows) {
        float sum = 0.f;
        for (int j = 0; j < nk; ++j)
          sum = fmaf(p_s[r * TK + j], v_s[j * D + tid], sum);
        acc[r] = acc[r] * a_s[r] + sum;
      }
    }
    __syncthreads();
  }
  __syncthreads();  // m_s/l_s of a block that walked no tile

  if (split_k == 1) {
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < nrows) {
        const float l = l_s[r];
        const int s = (r0 + r) / G, g = (r0 + r) % G;
        store(out + ((size_t)(b * S + s) * NQ + h * G + g) * D + tid,
              acc[r] / (l == 0.f ? 1.f : l));
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < nrows) {
        const size_t row =
            ((size_t)(b * NKV + h) * split_k + split) * rows + r0 + r;
        acc_out[row * D + tid] = acc[r];
        if (tid == 0) {
          m_out[row] = m_s[r];
          l_out[row] = l_s[r];
        }
      }
    }
  }
}

// Split-K epilogue: one block per (slot, kv head, query row), D threads.
// An empty split (m = NEG_INF, l = 0, acc = 0) weighs nothing; l* = 0
// (parked slot, or a row with no visible key) writes exact zeros.
template <typename Elem>
__global__ void merge_splits_kernel(const float* __restrict__ acc,
                                    const float* __restrict__ m,
                                    const float* __restrict__ l,
                                    Elem* __restrict__ out, int S, int NQ,
                                    int NKV, int D, int split_k) {
  const int G = NQ / NKV;
  const int rows = G * S;
  const int bh = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const size_t row0 = (size_t)bh * split_k * rows + r;
  float m_star = NEG_INF;
  for (int s = 0; s < split_k; ++s) m_star = fmaxf(m_star, m[row0 + (size_t)s * rows]);
  float l_star = 0.f, o = 0.f;
  for (int s = 0; s < split_k; ++s) {
    const size_t row = row0 + (size_t)s * rows;
    const float w = expf(m[row] - m_star);
    l_star += l[row] * w;
    o += acc[row * D + tid] * w;
  }
  const int b = bh / NKV, h = bh % NKV, s = r / G, g = r % G;
  store(out + ((size_t)(b * S + s) * NQ + h * G + g) * D + tid,
        o / (l_star == 0.f ? 1.f : l_star));
}

// the page params of an int8 pool: k scale, k zero, v scale, v zero
struct PageParams {
  const float* ks;
  const float* kz;
  const float* vs;
  const float* vz;
};

template <typename Elem, typename KV, int D>
int launch(const void* q, const void* k, const void* v, PageParams pp,
           const int* bt, const int* off, const int* start, void* out,
           float* acc, float* m, float* l, int B, int S, int NQ, int NKV,
           int NP, int page, int PP, float sm_scale, int window,
           float softcap, int split_k, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<Elem, KV, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = NQ / NKV * S;
  dim3 grid(B * NKV, split_k, (rows + MAX_ROWS - 1) / MAX_ROWS);
  paged_attention_kernel<Elem, KV, D><<<grid, D, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), pp.ks, pp.kz, pp.vs, pp.vz, bt, off, start,
      static_cast<Elem*>(out), acc, m, l, S, NQ, NKV, NP, page, PP, sm_scale,
      window, softcap, split_k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split_k == 1) return (int)e;
  merge_splits_kernel<Elem><<<dim3(B * NKV, rows), D, 0, stream>>>(
      acc, m, l, static_cast<Elem*>(out), S, NQ, NKV, D, split_k);
  return (int)cudaGetLastError();
}

template <typename Elem, typename KV>
int launch_d(int D, const void* q, const void* k, const void* v,
             PageParams pp, const int* bt, const int* off, const int* start,
             void* out, float* acc, float* m, float* l, int B, int S, int NQ,
             int NKV, int NP, int page, int PP, float sm_scale, int window,
             float softcap, int split_k, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<Elem, KV, 64>(q, k, v, pp, bt, off, start, out, acc, m,
                                  l, B, S, NQ, NKV, NP, page, PP, sm_scale,
                                  window, softcap, split_k, stream);
    case 128:
      return launch<Elem, KV, 128>(q, k, v, pp, bt, off, start, out, acc, m,
                                   l, B, S, NQ, NKV, NP, page, PP, sm_scale,
                                   window, softcap, split_k, stream);
    case 256:
      return launch<Elem, KV, 256>(q, k, v, pp, bt, off, start, out, acc, m,
                                   l, B, S, NQ, NKV, NP, page, PP, sm_scale,
                                   window, softcap, split_k, stream);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out).  quant: 0 = k and v pages
// in q's type, 1 = int8 pages with [NP] fp32 page params k_scale, k_zero,
// v_scale, v_zero (x = (code + 128) * scale + zero; ignored when quant is
// 0).  out is always [B, S, NQ, D]; acc, m and l are the split-K
// workspace (unused when split_k == 1).  window <= 0 and softcap <= 0
// mean "none".  Returns cudaGetLastError() after the launches (0 =
// launched), or -1 for an argument the kernel does not take.  Pages must
// be 16-byte aligned.
extern "C" int paged_attention_fwd(
    int dtype, int quant, const void* q, const void* k, const void* v,
    const void* k_scale, const void* k_zero, const void* v_scale,
    const void* v_zero, const void* block_table, const void* cache_offset,
    const void* kv_start, void* out, void* acc, void* m, void* l, int B,
    int S, int NQ, int NKV, int D, int NP, int page, int PP, float sm_scale,
    int window, float softcap, int split_k, void* stream) {
  if (NKV <= 0 || NQ % NKV != 0 || split_k < 1 || B < 1 || S < 1) return -1;
  const PageParams pp{static_cast<const float*>(k_scale),
                      static_cast<const float*>(k_zero),
                      static_cast<const float*>(v_scale),
                      static_cast<const float*>(v_zero)};
  if (quant && !(pp.ks && pp.kz && pp.vs && pp.vz)) return -1;
  const int* bt = static_cast<const int*>(block_table);
  const int* off = static_cast<const int*>(cache_offset);
  const int* st = static_cast<const int*>(kv_start);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && quant == 0)
    return launch_d<float, float>(D, q, k, v, pp, bt, off, st, out, a, mm, ll,
                                  B, S, NQ, NKV, NP, page, PP, sm_scale,
                                  window, softcap, split_k, s);
  if (dtype == 1 && quant == 0)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k, v, pp, bt, off, st, out, a, mm, ll, B, S, NQ, NKV, NP, page,
        PP, sm_scale, window, softcap, split_k, s);
  if (dtype == 0 && quant == 1)
    return launch_d<float, int8_t>(D, q, k, v, pp, bt, off, st, out, a, mm,
                                   ll, B, S, NQ, NKV, NP, page, PP, sm_scale,
                                   window, softcap, split_k, s);
  if (dtype == 1 && quant == 1)
    return launch_d<__nv_bfloat16, int8_t>(
        D, q, k, v, pp, bt, off, st, out, a, mm, ll, B, S, NQ, NKV, NP, page,
        PP, sm_scale, window, softcap, split_k, s);
  return -1;
}
