// Multi-token flash-attention forward for Hopper (sm_90a), bf16 in, f32 math.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_fwd_kernel).
//
// What bounds it on the H100: operations.  At the serving prompt (3072
// tokens, 8 heads, d = 256, causal) the two products do ~4e10 FLOP on
// ~28 MB, about 1400 FLOP per byte, well above the ~295 FLOP/byte at which
// the bf16 tensor cores (989 TFLOP/s) and not memory set the pace.
//
// What the design does about it:
//  * One block of 4 warps per (64-query tile, q head, row); the TPU's
//    sequential kv grid axis becomes a loop over key tiles inside the block,
//    with the online-softmax state (m, l, acc) in registers, f32.
//  * Both products run on the tensor cores through mma.sync m16n8k16 (bf16
//    in, f32 accumulate), with operands fetched by ldmatrix (V transposed
//    on the fly by ldmatrix.trans).  Each warp owns 16 query rows; the score
//    tile stays in registers and is re-packed as the A operand of the PV
//    product, so it never touches shared or device memory.
//  * Key/value tiles are double-buffered in shared memory and fetched with
//    cp.async, so the next tile's loads run under the current tile's math.
//  * K/V are read at the native kv-head count: q head h reads kv head
//    h / (H / K).  That computes what the reference's _expand_kv + kernel
//    compute, without materialising the repeat.
//  * A small first kernel records each key tile's (min, max) live position.
//    A tile in which every (query, key) pair of the block is masked (no live
//    key, all keys after the block's last causal position, or all outside
//    the window) is neither loaded nor computed: half the tiles at a causal
//    prefill.  A row with no valid key must still come out as the mean of V
//    over all T keys, as in the reference; if tiles were skipped, such rows
//    take that mean from a separate pass over V.
//  * The ragged edges are masked, not padded: rows past S are not stored,
//    keys past T get p = 0.  Any S and T work.
//  * Shared-memory rows are padded by 8 elements so that ldmatrix's eight
//    row addresses fall in distinct banks.
//
// Not yet used: TMA, wgmma, warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;                 // query rows per block, 16 per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16-byte (or 4-byte) async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (min, max) live key position of every BK-key tile of every row; min =
// INT32_MAX marks a tile without a live key.  One warp per (tile, row).
__global__ void tile_stats_kernel(const int* __restrict__ k_pos,
                                  int* __restrict__ stats, int T, int BK) {
  const int j = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  int mn = INT32_MAX, mx = INT32_MIN;
  for (int c = lane; c < BK; c += 32) {
    const int t = j * BK + c;
    if (t < T) {
      const int kp = k_pos[(size_t)b * T + t];
      if (kp >= 0) { mn = min(mn, kp); mx = max(mx, kp); }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    stats[((size_t)b * gridDim.x + j) * 2] = mn;
    stats[((size_t)b * gridDim.x + j) * 2 + 1] = mx;
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                 const int* __restrict__ tile_stats,
                 __nv_bfloat16* __restrict__ out, int S, int T, int H, int K,
                 int causal, int window, float softcap, float scale) {
  constexpr int DS = D + 8;             // padded row of Qs / Ks / Vs
  constexpr int NT = D / 8;             // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kBQ][DS]
  __nv_bfloat16* Ks = Qs + kBQ * DS;                                // [2][BK][DS]
  __nv_bfloat16* Vs = Ks + 2 * BK * DS;                             // [2][BK][DS]
  int* kps = reinterpret_cast<int*>(Vs + 2 * BK * DS);              // [2][BK]
  __shared__ int q_lo, q_hi;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wr = warp * 16;             // first row of this warp in the tile
  const size_t q_row = (size_t)H * D, kv_row = (size_t)K * D;
  const int ntiles = (T + BK - 1) / BK;
  const int* stats = tile_stats + (size_t)b * ntiles * 2;

  // Q tile (rows past S are zero and never stored)
  for (int idx = tid; idx < kBQ * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < S)
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * S + q0 + r) * q_row + (size_t)h * D + c);
    *reinterpret_cast<uint4*>(Qs + r * DS + c) = val;
  }
  if (tid == 0) { q_lo = INT32_MAX; q_hi = INT32_MIN; }
  __syncthreads();
  if (tid < kBQ && q0 + tid < S) {
    atomicMin(&q_lo, q_pos[(size_t)b * S + q0 + tid]);
    atomicMax(&q_hi, q_pos[(size_t)b * S + q0 + tid]);
  }
  const int ra = q0 + wr + g, rb = ra + 8;
  const int qpa = ra < S ? q_pos[(size_t)b * S + ra] : -1;
  const int qpb = rb < S ? q_pos[(size_t)b * S + rb] : -1;
  __syncthreads();
  const int qmin = q_lo, qmax = q_hi;

  // a tile is dead when every (row, key) pair of the block is masked
  auto dead = [&](int j) {
    const int kmin = stats[2 * j], kmax = stats[2 * j + 1];
    return kmin == INT32_MAX || (causal && kmin > qmax) ||
           (long long)qmin - kmax >= window;
  };
  auto issue = [&](int j, int buf) {
    const int t0 = j * BK;
    __nv_bfloat16* kd = Ks + buf * BK * DS;
    __nv_bfloat16* vd = Vs + buf * BK * DS;
    for (int idx = tid; idx < BK * (D / 8); idx += kThreads) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const bool in = t0 + r < T;
      const size_t off = in ? ((size_t)b * T + t0 + r) * kv_row + (size_t)kh * D + c : 0;
      cp_async16(kd + r * DS + c, k + off, in ? 16 : 0);
      cp_async16(vd + r * DS + c, v + off, in ? 16 : 0);
    }
    if (tid < BK) {
      const bool in = t0 + tid < T;
      cp_async4(kps + buf * BK + tid, k_pos + (in ? (size_t)b * T + t0 + tid : 0),
                in ? 4 : 0);
    }
    cp_async_commit();
  };

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  bool skipped = false;

  int cur = 0;
  while (cur < ntiles && dead(cur)) { ++cur; skipped = true; }
  if (cur < ntiles) issue(cur, 0);
  int buf = 0;
  while (cur < ntiles) {
    int nxt = cur + 1;
    while (nxt < ntiles && dead(nxt)) { ++nxt; skipped = true; }
    if (nxt < ntiles) {
      issue(nxt, buf ^ 1);              // overlaps this tile's math
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = cur * BK;
    const __nv_bfloat16* Kb = Ks + buf * BK * DS;
    const __nv_bfloat16* Vb = Vs + buf * BK * DS;
    const int* kp_t = kps + buf * BK;

    // S = Q K^T for this warp's 16 rows x BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * DS +
                         kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kb + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * DS +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jj], a, bk);
        mma_bf16(s[2 * jj + 1], a, bk + 2);
      }
    }

    // masks, softcap, online softmax (rows ra: e = 0,1; rb: e = 2,3)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tig * 2 + (e & 1);
        const int kp = kp_t[c];
        const int qp = e < 2 ? qpa : qpb;
        float x;
        if (t0 + c >= T) {
          x = -INFINITY;                // past the last key: p = 0
        } else {
          x = s[j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const bool ok = kp >= 0 && (!causal || qp >= kp) &&
                          (long long)qp - kp < window;
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn_a);
      s[j][1] = expf(s[j][1] - mn_a);
      s[j][2] = expf(s[j][2] - mn_b);
      s[j][3] = expf(s[j][3] - mn_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr_a; o[n][1] *= corr_a;
      o[n][2] *= corr_b; o[n][3] *= corr_b;
    }

    // O += P V, P re-packed from the score accumulators (p in V's dtype)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS +
                                  nn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * nn], a, bv);
        mma_bf16(o[2 * nn + 1], a, bv + 2);
      }
    }
    __syncthreads();                    // buffer free for the tile after next
    buf ^= 1;
    cur = nxt;
  }

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  // rows with no valid key (m never left NEG_INF): mean of V over all T
  const bool dead_a = ra < S && m_a == kNegInf, dead_b = rb < S && m_b == kNegInf;
  float* vmean = reinterpret_cast<float*>(Ks);       // [D], Ks is free now
  const bool need_mean = __syncthreads_or(skipped && (dead_a || dead_b));
  if (need_mean) {
    constexpr int CV = D / 8;                         // column vectors
    constexpr int RG = kThreads / CV;                 // row groups
    float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int cv = tid % CV, rg = tid / CV;
    for (int t = rg; t < T; t += RG) {
      uint4 vv = *reinterpret_cast<const uint4*>(
          v + ((size_t)b * T + t) * kv_row + (size_t)kh * D + cv * 8);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) part[e] += __bfloat162float(ve[e]);
    }
    float* red = reinterpret_cast<float*>(Qs);        // [RG][D], Qs is free
#pragma unroll
    for (int e = 0; e < 8; ++e) red[rg * D + cv * 8 + e] = part[e];
    __syncthreads();
    for (int c = tid; c < D; c += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < RG; ++r) sum += red[r * D + c];
      vmean[c] = sum / (float)T;
    }
    __syncthreads();
  }

  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + tig * 2;
    if (ra < S) {
      float x0 = o[n][0] * inv_a, x1 = o[n][1] * inv_a;
      if (need_mean && dead_a) { x0 = vmean[c]; x1 = vmean[c + 1]; }
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * S + ra) * q_row +
                                   (size_t)h * D + c) = pack_bf16(x0, x1);
    }
    if (rb < S) {
      float x0 = o[n][2] * inv_b, x1 = o[n][3] * inv_b;
      if (need_mean && dead_b) { x0 = vmean[c]; x1 = vmean[c + 1]; }
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * S + rb) * q_row +
                                   (size_t)h * D + c) = pack_bf16(x0, x1);
    }
  }
}

template <int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* k_pos, void* tile_stats,
                   void* out, int B, int S, int T, int H, int K, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const int smem = (kBQ * (D + 8) + 4 * BK * (D + 8)) * 2 + 2 * BK * 4;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int ntiles = (T + BK - 1) / BK;
  tile_stats_kernel<<<dim3(ntiles, B), 32, 0, stream>>>(
      (const int*)k_pos, (int*)tile_stats, T, BK);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D, BK><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)q_pos, (const int*)k_pos,
      (const int*)tile_stats, (__nv_bfloat16*)out, S, T, H, K, causal, window,
      softcap, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// Key tile length of the kernel at head_dim D (the wrapper sizes the
// tile_stats scratch with it).
extern "C" int repro_flash_attention_key_tile(int D) {
  return D == 256 ? 32 : 64;
}

// q (B, S, H, D), k and v (B, T, K, D) bf16 contiguous, H % K == 0;
// q_pos (B, S), k_pos (B, T) int32 (-1 = empty); tile_stats int32 scratch of
// B * ceil(T / key_tile) * 2; out (B, S, H, D) bf16.  window > 0;
// softcap <= 0 means none.  Returns a cudaError_t (0 = launched).
extern "C" int repro_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, void* tile_stats, void* out, int B, int S, int T,
    int H, int K, int D, int causal, int window, float softcap, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch<64, 64>(q, k, v, q_pos, k_pos, tile_stats, out, B, S, T,
                            H, K, causal, window, softcap, s);
    case 128:
      return launch<128, 64>(q, k, v, q_pos, k_pos, tile_stats, out, B, S, T,
                             H, K, causal, window, softcap, s);
    case 256:
      return launch<256, 32>(q, k, v, q_pos, k_pos, tile_stats, out, B, S, T,
                             H, K, causal, window, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
