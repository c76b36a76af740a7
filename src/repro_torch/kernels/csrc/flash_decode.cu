// Grouped split-KV flash decode for Hopper (sm_90a), f32 math.
//
// Replaces the TPU kernels repro/kernels/flash_decode.py::flash_decode_pallas
// (_decode_kernel), its log-sum-exp epilogue combine_partials,
// flash_decode_paged (_paged_decode_kernel) and flash_decode_pallas_quant
// (_decode_kernel_quant).  They are one kernel: where key t of row b lives is
// a template policy (ContiguousKeys, PagedKeys), the K/V element type another
// (bf16, or int8 / fp8 e4m3 with one f32 scale per (token, kv head)), and
// everything else -- the key loop, the softmax, the PV sum and the combine --
// is shared.  So with the same split length the paged kernel on a pool is
// bit-equal to the contiguous kernel on the gathered view, and the quantized
// kernel with every scale 1 is bit-equal to the bf16 kernel on the same
// values widened to bf16 (every int8 and e4m3 value is exact in bf16).
//
// Quantized K/V: each loaded row is widened to f32 and multiplied by its
// scale before the dot product and before the PV sum, as the reference twin
// quant.flash_decode_quant_ref dequantizes before its decode; a masked key's
// row and scale are never read.  The cache bytes per key fall from 2 D to
// D + 4 per tensor, so the byte bound falls by about half.
//
// Paged addressing: key t of row b is offset t % BS of pool block
// bt[b, t / BS].  An unmapped entry (-1) gives the key position -1, so it
// is masked like an empty slot and its row is never loaded.  The TPU ran one
// grid step per pool block; 16 keys are far too little work for a block
// here, so the paged kernel keeps the contiguous kernel's split length and
// a split walks several pool blocks.
//
// What bounds it on the H100: memory.  One query token per row meets
// every live K/V byte once, about 2 FLOP per byte read, far below the
// ~295 FLOP/byte at which the tensor cores become the limit.  The least
// time is the live K/V bytes over 3.35 TB/s.
//
// What the design does about it:
//  * The G = H / K query heads that share one KV head ride together, so
//    each K/V row is read from device memory once and used by all G heads
//    (the TPU kernel's (G, d) q tile).  A key whose position is masked is
//    not read at all.
//  * The key axis is split across blocks (grid = splits x K x B): at the
//    serving shape B x K is only 4, so the wrapper picks the split length
//    to put a few hundred blocks on the 132 SMs.  The TPU ran its splits in
//    sequence; here they run in parallel and a second, small kernel in this
//    file does the cross-block log-sum-exp combine.
//  * In a block, each warp takes groups of 4 keys and keeps their 4 row
//    loads in flight at once (the loop is latency-bound otherwise); a lane
//    owns d/32 consecutive elements of a row and loads them with one vector
//    load (16 bytes at d = 256).  The G dot products are reduced with warp
//    shuffles.  Scores live in shared memory, so the softmax of a split is
//    exact (max first, then exp), with no running rescale.
//  * The combine runs one block per (row, q head), enough to keep the loads
//    of all splits' partials in flight.
//  * The ragged tail is handled by the split length, not by padding.  A
//    split with no valid key writes (m = NEG_INF, l = 0) and drops out of
//    the combine; a row with no valid key anywhere comes out as zeros.
//
// Numerics follow the reference: f32 scores, tanh softcap, masked score
// NEG_INF, p = exp(s - m) in f32 for l and rounded to bf16 (q's dtype) for
// the PV sum, also over dequantized f32 K/V, as the reference twins do.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <int VEC>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  // VEC consecutive bf16 values, loaded with one vector instruction
  if constexpr (VEC == 8) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else if constexpr (VEC == 4) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    static_assert(VEC == 2, "head_dim must be 64, 128 or 256");
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  }
}

// Load policy of the one-byte element types (int8_t, __nv_fp8_e4m3): VEC
// consecutive elements in one vector load of VEC bytes, widened to f32.
template <int VEC> struct ByteVec;
template <> struct ByteVec<8> { using type = uint2; };
template <> struct ByteVec<4> { using type = uint32_t; };
template <> struct ByteVec<2> { using type = uint16_t; };

template <int VEC, class E>
__device__ __forceinline__ void load_row(const E* p, float* out) {
  static_assert(sizeof(E) == 1, "one-byte K/V elements");
  using Raw = typename ByteVec<VEC>::type;
  const Raw raw = *reinterpret_cast<const Raw*>(p);
  const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = static_cast<float>(e[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ bool key_valid(int qp, int kp, int causal, int window) {
  return kp >= 0 && (!causal || qp >= kp) && (qp - kp) < window;
}

// Where key t of row b lives.  pos(b, t) is its position (-1 = empty);
// row(b, t) the index of its (K, D) row in the K/V tensors, called only
// for a key with pos >= 0.
struct ContiguousKeys {              // k, v (B, T, K, D); k_pos (B, T)
  const int* k_pos;
  int T;
  __device__ __forceinline__ int pos(int b, int t) const {
    return k_pos[(size_t)b * T + t];
  }
  __device__ __forceinline__ int row(int b, int t) const { return b * T + t; }
};

struct PagedKeys {                   // pools (NB, BS, K, D); kp (NB, BS); bt (B, MAXB)
  const int* kp_pool;
  const int* bt;
  int maxb, bs;
  __device__ __forceinline__ int block(int b, int t) const {
    return bt[(size_t)b * maxb + t / bs];
  }
  __device__ __forceinline__ int pos(int b, int t) const {
    const int blk = block(b, t);
    return blk < 0 ? -1 : kp_pool[(size_t)blk * bs + t % bs];
  }
  __device__ __forceinline__ int row(int b, int t) const {
    return block(b, t) * bs + t % bs;
  }
};

// One block per (split, kv head, row) over T keys per row.  Shared memory:
// scores/probabilities [G][chunk], the cross-warp reduction buffer [G][D],
// and per key the K/V row index, -1 for a masked key [chunk].  E is the K/V
// element type; for int8 and fp8, k_scale and v_scale hold one f32 per
// (row index, kv head), laid out like the K/V rows with D dropped.
template <int D, int G, class E, class Keys>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const __nv_bfloat16* __restrict__ q,
                      const E* __restrict__ k, const E* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ q_pos, const Keys keys,
                      float* __restrict__ o_part, float* __restrict__ m_part,
                      float* __restrict__ l_part, int T, int K, int chunk,
                      int causal, int window, float softcap, float scale) {
  constexpr bool kQuant = !std::is_same<E, __nv_bfloat16>::value;
  constexpr int VEC = D / 32;
  constexpr int U = 4;                 // keys in flight per warp
  extern __shared__ float smem[];
  float* s_buf = smem;                 // [G][chunk]
  float* red = smem + G * chunk;       // [G][D]
  int* rows = reinterpret_cast<int*>(red + G * D);   // [chunk]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = split * chunk;
  const int n = min(chunk, T - t0);
  const int qp = q_pos[b];
  const int H = K * G;
  const size_t row_stride = (size_t)K * D;
  const E* kbase = k + (size_t)kh * D + lane * VEC;
  const E* vbase = v + (size_t)kh * D + lane * VEC;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int t = t0 + i;
    rows[i] = key_valid(qp, keys.pos(b, t), causal, window) ? keys.row(b, t) : -1;
  }
  __syncthreads();

  // phase A: scores of the split's keys for all G heads; each warp keeps U
  // row loads in flight, and a masked key is never read
  {
    float qreg[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g)
      load_row<VEC>(q + ((size_t)b * H + kh * G + g) * D + lane * VEC, qreg[g]);
    for (int i0 = warp * U; i0 < n; i0 += kWarps * U) {
      float kr[U][VEC], ks[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u < n && rows[i0 + u] >= 0) {
          load_row<VEC>(kbase + (size_t)rows[i0 + u] * row_stride, kr[u]);
          if constexpr (kQuant) ks[u] = k_scale[(size_t)rows[i0 + u] * K + kh];
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u;
        if (i >= n) break;
        if (rows[i] < 0) {
          if (lane < G) s_buf[lane * chunk + i] = -INFINITY;
          continue;
        }
        if constexpr (kQuant) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kr[u][e] *= ks[u];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float acc = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc += qreg[g][e] * kr[u][e];
          acc = warp_sum(acc) * scale;
          if (softcap > 0.f) acc = softcap * tanhf(acc / softcap);
          if (lane == 0) s_buf[g * chunk + i] = acc;
        }
      }
    }
  }
  __syncthreads();

  // phase B: exact softmax statistics of the split, one warp per head
  for (int g = warp; g < G; g += kWarps) {
    float* row = s_buf + g * chunk;
    float m = kNegInf;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, row[i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      float p = expf(row[i] - m);      // masked: exp(-inf) = 0
      l += p;
      row[i] = __bfloat162float(__float2bfloat16(p));   // p in V's dtype
    }
    l = warp_sum(l);
    if (lane == 0) {
      size_t idx = (((size_t)b * K + kh) * splits + split) * G + g;
      m_part[idx] = m;
      l_part[idx] = l;
    }
  }
  __syncthreads();

  // phase C: acc[g] = sum_t p[g][t] v[t], then a fixed-order warp reduction
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  for (int i0 = warp * U; i0 < n; i0 += kWarps * U) {
    float vr[U][VEC], vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u < n && rows[i0 + u] >= 0) {
        load_row<VEC>(vbase + (size_t)rows[i0 + u] * row_stride, vr[u]);
        if constexpr (kQuant) vs[u] = v_scale[(size_t)rows[i0 + u] * K + kh];
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u;
      if (i >= n) break;
      if (rows[i] < 0) continue;
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vr[u][e] *= vs[u];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = s_buf[g * chunk + i];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] += p * vr[u][e];
      }
    }
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float* dst = red + g * D + lane * VEC + e;
          *dst = (w == 0 ? 0.f : *dst) + acc[g][e];
        }
    }
    __syncthreads();
  }
  float* out = o_part + (((size_t)b * K + kh) * splits + split) * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) out[idx] = red[idx];
}

// Block-wide reduction over blockDim.x threads (a multiple of 32, <= 1024).
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  x = kMax ? warp_max(x) : warp_sum(x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  __syncthreads();                     // scratch free from a previous use
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = scratch[0];
  for (int w = 1; w < nw; ++w) x = kMax ? fmaxf(x, scratch[w]) : x + scratch[w];
  return x;
}

// One block of D threads per (row, kv head, q head of the group):
// log-sum-exp combine of the splits.  The split weights are computed once
// into shared memory; thread e then sums column e of the partials.
__global__ void combine_kernel(const float* __restrict__ o_part,
                               const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               __nv_bfloat16* __restrict__ out, int splits,
                               int G, int D) {
  extern __shared__ float w[];         // [splits]
  __shared__ float scratch[32];
  const int g = blockIdx.x % G, bk = blockIdx.x / G;   // bk = b * K + kh
  const float* m = m_part + (size_t)bk * splits * G + g;
  const float* l = l_part + (size_t)bk * splits * G + g;
  float mx = kNegInf;
  for (int s = threadIdx.x; s < splits; s += blockDim.x) mx = fmaxf(mx, m[s * G]);
  const float m_star = block_reduce<true>(mx, scratch);
  float ls = 0.f;
  for (int s = threadIdx.x; s < splits; s += blockDim.x) {
    const float alpha = expf(m[s * G] - m_star);
    w[s] = alpha;
    ls += l[s * G] * alpha;
  }
  const float l_star = block_reduce<false>(ls, scratch);  // also publishes w
  const int e = threadIdx.x;
  const float* o = o_part + ((size_t)bk * splits * G + g) * D + e;
  float acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) acc += o[(size_t)s * G * D] * w[s];
  out[((size_t)bk * G + g) * D + e] = __float2bfloat16(acc / fmaxf(l_star, 1e-30f));
}

template <int D, int G, class E, class Keys>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* q_pos, Keys keys, void* o_part, void* m_part,
                   void* l_part, void* out, int B, int T, int K, int chunk,
                   int splits, int causal, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem =
      ((size_t)G * chunk + (size_t)G * D) * sizeof(float) + chunk * sizeof(int);
  static size_t smem_set = 0;          // per instantiation: raise once
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(decode_partial_kernel<D, G, E, Keys>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  dim3 grid(splits, K, B);
  decode_partial_kernel<D, G, E, Keys><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const E*)k, (const E*)v,
      (const float*)k_scale, (const float*)v_scale, (const int*)q_pos, keys,
      (float*)o_part,
      (float*)m_part, (float*)l_part, T, K, chunk, causal, window, softcap,
      1.0f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<<<B * K * G, D, splits * sizeof(float), stream>>>(
      (const float*)o_part, (const float*)m_part, (const float*)l_part,
      (__nv_bfloat16*)out, splits, G, D);
  return cudaGetLastError();
}

template <class E, class Keys>
int launch_dg(int D, int G, const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* q_pos,
              Keys keys, void* o_part, void* m_part, void* l_part, void* out,
              int B, int T, int K, int chunk, int splits, int causal,
              int window, float softcap, void* stream) {
#define REPRO_DG(d, g)                                                     \
  if (D == d && G == g)                                                    \
    return (int)launch<d, g, E, Keys>(q, k, v, k_scale, v_scale, q_pos,    \
                                      keys, o_part, m_part, l_part, out,  \
                                      B, T, K, chunk, splits, causal,     \
                                      window, softcap,                    \
                                      (cudaStream_t)stream);
#define REPRO_D(d) \
  REPRO_DG(d, 1) REPRO_DG(d, 2) REPRO_DG(d, 4) REPRO_DG(d, 8) REPRO_DG(d, 16)
  REPRO_D(64)
  REPRO_D(128)
  REPRO_D(256)
#undef REPRO_D
#undef REPRO_DG
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, D) bf16; k, v (B, T, K, D) bf16 contiguous; q_pos (B,) int32;
// k_pos (B, T) int32; o_part (B, K, splits, G, D), m_part and l_part
// (B, K, splits, G) f32 scratch; out (B, H, D) bf16.  window > 0;
// softcap <= 0 means none.  Returns a cudaError_t (0 = launched).
extern "C" int repro_flash_decode_bf16(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, void* o_part, void* m_part, void* l_part, void* out,
    int B, int T, int K, int G, int D, int chunk, int splits, int causal,
    int window, float softcap, void* stream) {
  const ContiguousKeys keys{(const int*)k_pos, T};
  return launch_dg<__nv_bfloat16>(D, G, q, k, v, nullptr, nullptr, q_pos,
                                  keys, o_part, m_part, l_part, out, B, T, K,
                                  chunk, splits, causal, window, softcap,
                                  stream);
}

// As repro_flash_decode_bf16, with K/V read through block tables:
// k_pool, v_pool (NB, BS, K, D) bf16; kp_pool (NB, BS) int32; bt (B, MAXB)
// int32 with -1 = unmapped.  Row b's keys are the MAXB * BS keys its table
// maps, in table order.
extern "C" int repro_flash_decode_paged_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* q_pos,
    const void* kp_pool, const void* bt, void* o_part, void* m_part,
    void* l_part, void* out, int B, int MAXB, int BS, int K, int G, int D,
    int chunk, int splits, int causal, int window, float softcap,
    void* stream) {
  const PagedKeys keys{(const int*)kp_pool, (const int*)bt, MAXB, BS};
  return launch_dg<__nv_bfloat16>(D, G, q, k_pool, v_pool, nullptr, nullptr,
                                  q_pos, keys, o_part, m_part, l_part, out, B,
                                  MAXB * BS, K, chunk, splits, causal, window,
                                  softcap, stream);
}

// As repro_flash_decode_bf16, over a quantized cache: kq, vq (B, T, K, D)
// int8 (_int8) or fp8 e4m3 (_fp8); k_scale, v_scale (B, T, K) f32 contiguous.
extern "C" int repro_flash_decode_quant_int8(
    const void* q, const void* kq, const void* vq, const void* q_pos,
    const void* k_pos, const void* k_scale, const void* v_scale, void* o_part,
    void* m_part, void* l_part, void* out, int B, int T, int K, int G, int D,
    int chunk, int splits, int causal, int window, float softcap,
    void* stream) {
  const ContiguousKeys keys{(const int*)k_pos, T};
  return launch_dg<int8_t>(D, G, q, kq, vq, k_scale, v_scale, q_pos, keys,
                           o_part, m_part, l_part, out, B, T, K, chunk,
                           splits, causal, window, softcap, stream);
}

extern "C" int repro_flash_decode_quant_fp8(
    const void* q, const void* kq, const void* vq, const void* q_pos,
    const void* k_pos, const void* k_scale, const void* v_scale, void* o_part,
    void* m_part, void* l_part, void* out, int B, int T, int K, int G, int D,
    int chunk, int splits, int causal, int window, float softcap,
    void* stream) {
  const ContiguousKeys keys{(const int*)k_pos, T};
  return launch_dg<__nv_fp8_e4m3>(D, G, q, kq, vq, k_scale, v_scale, q_pos,
                                  keys, o_part, m_part, l_part, out, B, T, K,
                                  chunk, splits, causal, window, softcap,
                                  stream);
}
