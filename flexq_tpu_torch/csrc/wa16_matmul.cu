// W6A16 and W4A16 GEMMs for Hopper (sm_90a), plain C interface: the 6- or
// 4-bit weights are dequantized to bf16 in the kernel and multiplied with
// bf16 activations on the tensor cores, f32 accumulation.
//
// Replaces the TPU kernels
//   flexq_tpu/kernels/w6_matmul.py::w6_matmul_bf16      (_w6_bf16_kernel, K7),
//     with the optional RoPE epilogue flexq_tpu/kernels/common.py::rope_epilogue;
//   flexq_tpu/kernels/w6_matmul.py::w6_glu_matmul_bf16  (_w6_glu_bf16_kernel, K8)
//   flexq_tpu/kernels/w6_matmul.py::w6_glu_fused_bf16   (the same body, K8);
//   flexq_tpu/kernels/w4_matmul.py::w4_matmul_bf16      (_w4_bf16_kernel, K11),
//     K7 over the 4-bit nibble plane (FMT = 4), with the same RoPE epilogue.
//
//   K7:  out[m, n] = sum_k x[m, k] * bf16((u[k, n] - 32) * ws[k / 128, n])
//   K11: the same with u the biased 4-bit weight of the nibble plane, bias 8
//        with RoPE: out = t * cos + t[(c + 64) mod 128] * sin2 on the f32
//        accumulator t, c the column within its 128-wide head, before the cast.
//   K8:  out = act(g) * u for two such products g (gate) and u (up) of the
//        same x; act = silu (g * sigmoid(g)) or tanh-approximate gelu, in f32.
//        The fused-plane variant passes the up pointers as the gate pointers
//        offset by nh columns, with the plane's row stride: nothing is copied.
//
// Numerics: the dequantized weight is bf16((u - BIAS) * ws), one f32 multiply
// rounded to nearest-even, as the TPU kernel rounds it; bf16 x bf16 products
// are exact in f32, so the kernel and its plain version (an f32 product of the
// same bf16 operands) differ only in the order of the f32 sums.
//
// Bound on this card: operations at prefill (M = 2048, K = 4096, N = 11264:
// 189 GFLOP, 0.19 ms at 989 TFLOP/s, against about 0.03 ms of bytes), bytes at
// weight-only decode (M = 4: the planes, 0.75 B per weight for W6, 0.5 B for
// W4: 8.4 MB and 2.5 us for a 4096 x 4096 W4 matrix). Design,
// simple first: a block computes a BM x 128 output tile (one head, so the
// RoPE partner column is in the block) with 8 warps; per 128-deep K step (one
// pack K-tile = one quant group = one scale row) it copies the x tile into
// shared memory, dequantizes the 128 x 128 weight tile into shared memory in
// the layout the MMA reads, and runs wmma m16n16k16 bf16 -> f32 fragments;
// each thread loads the next step's x and plane words into registers while
// the tensor cores run the current one, so a step waits on one round of
// global loads, not one per copy. The epilogue stages the f32 accumulators
// through shared memory (the RoPE partner column sits in another thread's
// fragment) and writes coalesced rows. No wgmma/TMA and no shared-memory
// ring yet: that is later work. The W4 format (FMT = 4) loads only the
// nibble plane and dequantizes each nibble alone; K8 has no W4 counterpart
// in the reference (its W4 layers run two K11 GEMMs and the GLU apart).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "pack4.cuh"
#include "pack6.cuh"

using namespace nvcuda;

namespace {

constexpr int BN = 128;      // output columns per block: one 128-wide head
constexpr int BK = pack6::KT;  // K step: one pack K-tile, one quant group
constexpr int LDA = BK + 8;  // x tile row pitch (bf16), 16 B padding
constexpr int LDB = BN + 8;  // weight tile row pitch (bf16)
constexpr int LDC = BN + 4;  // accumulator staging row pitch (f32)
constexpr int THREADS = 256;

template <int BM, int NB>
constexpr size_t smem_bytes() {
  const size_t ab = (size_t)BM * LDA * 2 + (size_t)NB * BK * LDB * 2;
  const size_t cb = (size_t)NB * BM * LDC * 4;
  return ab > cb ? ab : cb;
}

// One K step's global data for this thread, loaded into registers a step
// ahead of its use. Weight item j of a thread is nibble (hi) row r =
// threadIdx.x / 32 + 8 j (rows r and r + 64 of the K-tile) of four adjacent
// columns; for FMT 6 rows r and r + 32 share their lo row, so four lo words
// serve the eight items.
constexpr int WITEMS = 64 * (BN / 4) / THREADS;

template <int BM, int NB, int FMT>
struct Stage {
  uint4 x[BM * (BK / 8) / THREADS];  // the x tile, 16 B per copy
  uint32_t h[NB][WITEMS];
  uint32_t l[NB][FMT == 6 ? WITEMS / 2 : 1];
  float4 s[NB];  // the step's scales of the thread's four columns
};

template <int BM, int NB, int FMT>
__device__ __forceinline__ void load_stage(Stage<BM, NB, FMT>& st, const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* const (&hi)[2],
                                           const uint8_t* const (&lo)[2],
                                           const float* const (&ws)[2], int M, int K, int ldw,
                                           int m0, int n0, int t) {
  const int xr = threadIdx.x / (BK / 8), xc = (threadIdx.x % (BK / 8)) * 8;
#pragma unroll
  for (int j = 0; j < BM * (BK / 8) / THREADS; ++j) {
    const int r = xr + j * (THREADS / (BK / 8));
    st.x[j] = make_uint4(0u, 0u, 0u, 0u);  // rows past M are zero
    if (m0 + r < M)
      st.x[j] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + (size_t)t * BK + xc);
  }
  const int wr = threadIdx.x / (BN / 4), wc = n0 + (threadIdx.x % (BN / 4)) * 4;
#pragma unroll
  for (int w = 0; w < NB; ++w) {
#pragma unroll
    for (int j = 0; j < WITEMS; ++j)
      st.h[w][j] = *reinterpret_cast<const uint32_t*>(hi[w] + (size_t)(t * 64 + wr + 8 * j) * ldw + wc);
    if constexpr (FMT == 6) {
#pragma unroll
      for (int j = 0; j < WITEMS / 2; ++j)
        st.l[w][j] = *reinterpret_cast<const uint32_t*>(lo[w] + (size_t)(t * 32 + wr + 8 * j) * ldw + wc);
    }
    st.s[w] = *reinterpret_cast<const float4*>(ws[w] + (size_t)t * ldw + wc);
  }
}

// Write a loaded step into shared memory: the x tile as is, each weight
// dequantized to bf16 into its [BK][LDB] tile (row = k).
template <int BM, int NB, int FMT>
__device__ __forceinline__ void store_stage(const Stage<BM, NB, FMT>& st, __nv_bfloat16* As,
                                            __nv_bfloat16* Bs) {
  const int xr = threadIdx.x / (BK / 8), xc = (threadIdx.x % (BK / 8)) * 8;
#pragma unroll
  for (int j = 0; j < BM * (BK / 8) / THREADS; ++j)
    *reinterpret_cast<uint4*>(As + (xr + j * (THREADS / (BK / 8))) * LDA + xc) = st.x[j];
  const int wr = threadIdx.x / (BN / 4), wc = (threadIdx.x % (BN / 4)) * 4;
#pragma unroll
  for (int w = 0; w < NB; ++w) {
    const float s[4] = {st.s[w].x, st.s[w].y, st.s[w].z, st.s[w].w};
    __nv_bfloat16* Bt = Bs + w * BK * LDB;
#pragma unroll
    for (int j = 0; j < WITEMS; ++j) {
      const int r = wr + 8 * j;
      const uint32_t h = st.h[w][j];
      uint32_t va[2] = {0u, 0u}, vb[2] = {0u, 0u};  // four bf16 each, column wc in the low half
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int ua, ub, bias;
        if constexpr (FMT == 6) {
          const uint32_t l = st.l[w][j % (WITEMS / 2)];
          pack6::unpack_pair((h >> (8 * q)) & 0xFFu, (l >> (8 * q)) & 0xFFu, r, ua, ub);
          bias = pack6::BIAS;
        } else {
          pack4::unpack_pair((h >> (8 * q)) & 0xFFu, ua, ub);
          bias = pack4::BIAS;
        }
        const uint32_t ba = __bfloat16_as_ushort(
            __float2bfloat16_rn(__fmul_rn(__int2float_rn(ua - bias), s[q])));
        const uint32_t bb = __bfloat16_as_ushort(
            __float2bfloat16_rn(__fmul_rn(__int2float_rn(ub - bias), s[q])));
        va[q >> 1] |= ba << (16 * (q & 1));
        vb[q >> 1] |= bb << (16 * (q & 1));
      }
      *reinterpret_cast<uint2*>(Bt + r * LDB + wc) = make_uint2(va[0], va[1]);
      *reinterpret_cast<uint2*>(Bt + (r + 64) * LDB + wc) = make_uint2(vb[0], vb[1]);
    }
  }
}

__device__ __forceinline__ float act_f32(float g, int act) {
  if (act == 0) return __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));  // silu
  // tanh-approximate gelu: g * 0.5 * (1 + tanh(sqrt(2/pi) * (g + 0.044715 g^3)))
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(g, __fmul_rn(0.044715f, __fmul_rn(__fmul_rn(g, g), g))));
  return __fmul_rn(g, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// NB = 1: K7 / K11 (ROPE optional); NB = 2: K8 (weight 0 = gate, weight 1 = up).
// FMT: 6 (hi + lo planes) or 4 (the nibble plane in the hi pointer).
template <int BM, int NB, bool ROPE, int FMT>
__global__ void __launch_bounds__(THREADS)
w6_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ hi0,
               const uint8_t* __restrict__ lo0, const float* __restrict__ ws0,
               const uint8_t* __restrict__ hi1, const uint8_t* __restrict__ lo1,
               const float* __restrict__ ws1, const float* __restrict__ cosv,
               const float* __restrict__ sin2, void* __restrict__ out, int M, int N, int K,
               int ldw, int out_bf16, int act) {
  constexpr int WARPS_M = BM / 32;            // each warp: 32 rows
  constexpr int WARPS_N = (THREADS / 32) / WARPS_M;
  constexpr int WN = BN / WARPS_N;            // columns per warp
  constexpr int FM = 2, FN = WN / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;          // NB tiles of BK * LDB
  float* Cs = reinterpret_cast<float*>(smem);  // NB tiles of BM * LDC, after the K loop

  const int warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][FM][FN];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) wmma::fill_fragment(acc[j][fm][fn], 0.0f);

  const uint8_t* const his[2] = {hi0, hi1};
  const uint8_t* const los[2] = {lo0, lo1};
  const float* const wss[2] = {ws0, ws1};
  const int nt = K / BK;
  Stage<BM, NB, FMT> st;
  load_stage(st, x, his, los, wss, M, K, ldw, m0, n0, 0);
  for (int t = 0; t < nt; ++t) {
    store_stage(st, As, Bs);
    __syncthreads();
    // the next step's loads are in flight while the tensor cores run this one
    if (t + 1 < nt) load_stage(st, x, his, los, wss, M, K, ldw, m0, n0, t + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
        wmma::load_matrix_sync(a[fm], As + (wm * 32 + fm * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Bs + j * BK * LDB + kk * LDB + wn * WN + fn * 16, LDB);
#pragma unroll
          for (int fm = 0; fm < FM; ++fm) wmma::mma_sync(acc[j][fm][fn], a[fm], b, acc[j][fm][fn]);
        }
    }
    __syncthreads();  // the tiles are rewritten by the next step (and by Cs)
  }

#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int fn = 0; fn < FN; ++fn)
        wmma::store_matrix_sync(Cs + j * BM * LDC + (wm * 32 + fm * 16) * LDC + wn * WN + fn * 16,
                                acc[j][fm][fn], LDC, wmma::mem_row_major);
  __syncthreads();

#pragma unroll 8
  for (int j = 0; j < BM * BN / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / BN, c = i % BN;
    const int m = m0 + r;
    if (m >= M) continue;
    float v = Cs[r * LDC + c];
    if (ROPE) {
      const float rot = Cs[r * LDC + (c ^ 64)];  // column (c + 64) mod 128 of this head
      v = __fadd_rn(__fmul_rn(v, cosv[(size_t)m * 128 + c]), __fmul_rn(rot, sin2[(size_t)m * 128 + c]));
    }
    if (NB == 2) v = __fmul_rn(act_f32(v, act), Cs[BM * LDC + r * LDC + c]);
    const size_t o = (size_t)m * N + n0 + c;
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
    else
      reinterpret_cast<float*>(out)[o] = v;
  }
}

template <int BM, int NB, bool ROPE, int FMT>
int launch(const void* x, const void* hi0, const void* lo0, const void* ws0, const void* hi1,
           const void* lo1, const void* ws1, const void* cosv, const void* sin2, void* out,
           int M, int N, int K, int ldw, int out_bf16, int act, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<BM, NB>();
  cudaError_t e = cudaFuncSetAttribute(w6_bf16_kernel<BM, NB, ROPE, FMT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  w6_bf16_kernel<BM, NB, ROPE, FMT><<<grid, THREADS, smem, s>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)hi0, (const uint8_t*)lo0, (const float*)ws0,
      (const uint8_t*)hi1, (const uint8_t*)lo1, (const float*)ws1, (const float*)cosv,
      (const float*)sin2, out, M, N, K, ldw, out_bf16, act);
  return (int)cudaGetLastError();
}

// One launch of the format's kernel; glu (K8) is W6 only.
template <int FMT>
int dispatch(const void* x, const void* hi0, const void* lo0, const void* ws0, const void* hi1,
             const void* lo1, const void* ws1, const void* cosv, const void* sin2, void* out, int M,
             int N, int K, int ldw, int out_bf16, int glu, int act, int bm, cudaStream_t s) {
  const bool rope = cosv != nullptr;
  if (glu) {
    if constexpr (FMT == 6) {
      if (bm != 64 || rope || (act != 0 && act != 1)) return (int)cudaErrorInvalidValue;
      return launch<64, 2, false, FMT>(x, hi0, lo0, ws0, hi1, lo1, ws1, nullptr, nullptr, out, M, N,
                                       K, ldw, out_bf16, act, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (bm == 64 && rope)
    return launch<64, 1, true, FMT>(x, hi0, lo0, ws0, nullptr, nullptr, nullptr, cosv, sin2, out, M,
                                    N, K, ldw, out_bf16, 0, s);
  if (bm == 64)
    return launch<64, 1, false, FMT>(x, hi0, lo0, ws0, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     out, M, N, K, ldw, out_bf16, 0, s);
  if (bm == 128 && rope)
    return launch<128, 1, true, FMT>(x, hi0, lo0, ws0, nullptr, nullptr, nullptr, cosv, sin2, out,
                                     M, N, K, ldw, out_bf16, 0, s);
  if (bm == 128)
    return launch<128, 1, false, FMT>(x, hi0, lo0, ws0, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      out, M, N, K, ldw, out_bf16, 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fmt 6 (K7 / K8): weight j is hi [K/2, ldw], lo [K/4, ldw], ws f32
// [K/128, ldw]; fmt 4 (K11): the nibble plane [K/2, ldw] in hi, lo null.
// Pointers at the weight's first column; x: bf16 [M, K]; out: [M, N] bf16
// or f32. glu = 0: K7 / K11 over weight 0, with RoPE when cos / sin2 (f32
// [M, 128]) are not null; glu = 1 (fmt 6 only): K8, weight 0 = gate, weight
// 1 = up, act 0 = silu, 1 = gelu. bm: rows per block, 64 or 128 (K8: 64).
// Returns cudaGetLastError() after the launch.
extern "C" int flexq_wa16_matmul(const void* x, const void* hi0, const void* lo0, const void* ws0,
                                 const void* hi1, const void* lo1, const void* ws1,
                                 const void* cosv, const void* sin2, void* out, int M, int N, int K,
                                 int ldw, int out_bf16, int glu, int act, int bm, int fmt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K % BK != 0 || N % BN != 0 || ldw % 4 != 0 || ldw < N)
    return (int)cudaErrorInvalidValue;
  if (fmt == 6)
    return dispatch<6>(x, hi0, lo0, ws0, hi1, lo1, ws1, cosv, sin2, out, M, N, K, ldw, out_bf16, glu,
                       act, bm, s);
  if (fmt == 4)
    return dispatch<4>(x, hi0, lo0, ws0, hi1, lo1, ws1, cosv, sin2, out, M, N, K, ldw, out_bf16, glu,
                       act, bm, s);
  return (int)cudaErrorInvalidValue;
}
