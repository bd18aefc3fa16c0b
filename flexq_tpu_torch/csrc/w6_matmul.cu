// W6Ax grouped integer GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels flexq_tpu/kernels/w6_matmul.py::w6_matmul
// (_w6_matmul_kernel) and flexq_tpu/kernels/w6_stream.py::w6_matmul_stream
// (_kernel): one function, two launch shapes (KS below).
//
//   out[m, n] = sum over 128-groups g, in order g = 0, 1, ..., of
//               float(P[m,g,n] - 32 * Sx[m,g]) * (xs[m,g] * ws[g,n])
//   P[m,g,n]  = sum_{k in g} xq[m,k] * u[k,n]   (u = biased 6-bit weight)
//   Sx[m,g]   = sum_{k in g} xq[m,k]
//
// The integer part is exact (|P - 32 Sx| < 2^24, so its float is exact too)
// and the scale algebra uses __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA, in the reference's order: the result equals the
// plain PyTorch version (w6_matmul_plain) bit for bit.
//
// Bound on this card: bytes. At decode (M <= 32) every weight is used by at
// most 32 rows; LLaMA-2-7B streams ~160 MB of planes and scales per layer
// (0.75 B per weight + 4 B per 128 weights), ~5.1 GB per decode step over
// 32 layers, ~1.5 ms at 3.35 TB/s. The design keeps the N-minor plane layout
// as stored (flexq_tpu/packing/pack6.py), so lane n of a warp reads column n:
// the 32 lanes read 32 consecutive bytes of each plane row, one sector per
// load. To put enough bytes in flight, each block splits K across KS warps
// (warp w unpacks group g0 + w of each round of KS groups) and the per-group
// f32 terms go through shared memory to one owner thread per output, which
// adds them in group order. No tensor cores: dp4a on the unpacked words.
// A wgmma repack of the planes is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// 4 byte values (each in the low 8 bits of a word) -> one packed word
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

template <int KS, int BM>
__global__ void __launch_bounds__(KS * 32)
w6_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const uint8_t* __restrict__ hi, const uint8_t* __restrict__ lo,
                 const float* __restrict__ ws, void* __restrict__ out,
                 int M, int N, int K, int out_bf16) {
  __shared__ int xt[BM][KS * 32];      // this round's activations, 4 k per word
  __shared__ float terms[KS][BM][32];  // this round's per-group terms
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * BM;
  const int G = K / 128;
  const int KW = K / 4;
  float acc = 0.f;  // owned by threads w < BM: output (m0 + w, n)

  for (int g0 = 0; g0 < G; g0 += KS) {
    for (int i = threadIdx.x; i < BM * KS * 32; i += KS * 32) {
      const int m = i / (KS * 32), j = i % (KS * 32);
      const int kw = g0 * 32 + j;
      int v = 0;
      if (m0 + m < M && kw < KW)
        v = reinterpret_cast<const int*>(xq + (size_t)(m0 + m) * K)[kw];
      xt[m][j] = v;
    }
    __syncthreads();

    const int g = g0 + w;
    if (g < G && n < N) {
      const uint8_t* hp = hi + (size_t)g * 64 * N + n;
      const uint8_t* lp = lo + (size_t)g * 32 * N + n;
      uint32_t lw[8];  // lo bytes of rows r = 0..31, four rows per word
#pragma unroll
      for (int j = 0; j < 8; ++j)
        lw[j] = pack4(lp[(size_t)(4 * j) * N], lp[(size_t)(4 * j + 1) * N],
                      lp[(size_t)(4 * j + 2) * N], lp[(size_t)(4 * j + 3) * N]);
      int dot[BM], sx[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) dot[m] = sx[m] = 0;
      const int* xg = &xt[0][w * 32];
      // half 0: hi rows 0..31 hold k 0..31 (low nibble) and k 64..95 (high
      // nibble); half 1: hi rows 32..63 hold k 32..63 and k 96..127.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t hw[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint8_t* p = hp + (size_t)(32 * half + 4 * j) * N;
          hw[j] = pack4(p[0], p[N], p[2 * (size_t)N], p[3 * (size_t)N]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // quarter qa = half holds k = 32*half + 4j .., crumbs at bits 2*half
          // quarter qb = half + 2 holds k = 64 + 32*half + 4j .., bits 2*(half+2)
          const uint32_t ua = ((hw[j] & 0x0F0F0F0Fu) << 2) | ((lw[j] >> (2 * half)) & 0x03030303u);
          const uint32_t ub = (((hw[j] >> 4) & 0x0F0F0F0Fu) << 2) |
                              ((lw[j] >> (2 * half + 4)) & 0x03030303u);
          const int wa = 8 * half + j, wb = 16 + 8 * half + j;  // word index in group
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            const int xa = xg[m * KS * 32 + wa];
            const int xb = xg[m * KS * 32 + wb];
            dot[m] = __dp4a(xa, (int)ua, dot[m]);
            dot[m] = __dp4a(xb, (int)ub, dot[m]);
            sx[m] = __dp4a(xa, 0x01010101, sx[m]);
            sx[m] = __dp4a(xb, 0x01010101, sx[m]);
          }
        }
      }
      const float wsc = ws[(size_t)g * N + n];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xsc = (m0 + m < M) ? xs[(size_t)(m0 + m) * G + g] : 0.f;
        const int part = dot[m] - 32 * sx[m];
        terms[w][m][lane] = __fmul_rn(__int2float_rn(part), __fmul_rn(xsc, wsc));
      }
    }
    __syncthreads();

    if (w < BM) {
      const int nv = min(KS, G - g0);
      for (int i = 0; i < nv; ++i) acc = __fadd_rn(acc, terms[i][w][lane]);
    }
  }
  if (w < BM && m0 + w < M && n < N) {
    const size_t o = (size_t)(m0 + w) * N + n;
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(acc);
    else
      reinterpret_cast<float*>(out)[o] = acc;
  }
}

template <int KS, int BM>
void launch(const void* xq, const void* xs, const void* hi, const void* lo, const void* ws,
            void* out, int M, int N, int K, int out_bf16, cudaStream_t s) {
  dim3 grid((N + 31) / 32, (M + BM - 1) / BM);
  w6_matmul_kernel<KS, BM><<<grid, KS * 32, 0, s>>>(
      (const int8_t*)xq, (const float*)xs, (const uint8_t*)hi, (const uint8_t*)lo,
      (const float*)ws, out, M, N, K, out_bf16);
}

}  // namespace

// ks: warps splitting K in a block (8: grid kernel, 16: K-tall decode shapes);
// bm: rows per block (4 or 8). Returns cudaGetLastError() after the launch.
extern "C" int flexq_w6_matmul(const void* xq, const void* xs, const void* hi,
                               const void* lo, const void* ws, void* out, int M, int N,
                               int K, int out_bf16, int ks, int bm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 128 != 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (ks == 8 && bm == 8) launch<8, 8>(xq, xs, hi, lo, ws, out, M, N, K, out_bf16, s);
  else if (ks == 8 && bm == 4) launch<8, 4>(xq, xs, hi, lo, ws, out, M, N, K, out_bf16, s);
  else if (ks == 16 && bm == 8) launch<16, 8>(xq, xs, hi, lo, ws, out, M, N, K, out_bf16, s);
  else if (ks == 16 && bm == 4) launch<16, 4>(xq, xs, hi, lo, ws, out, M, N, K, out_bf16, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
