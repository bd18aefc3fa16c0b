// Exact grouped integer GEMMs for Hopper (sm_90a), plain C interface: W4A8
// and W8A8, the weight format a template parameter. (The 6-bit format, K2 /
// K3, has its own source: w6ax_matmul.cu.)
//
// Replaces the TPU kernels
//   flexq_tpu/kernels/w4_matmul.py::w4_matmul        (_w4_matmul_kernel, K10)
//   flexq_tpu/kernels/w8_matmul.py::w8_matmul        (_w8_kernel, K12)
// one body, two weight formats (FMT), two launch shapes (KS below).
//
//   out[m, n] = sum over 128-groups g, in order g = 0, 1, ..., of
//               float(P[m,g,n] - BIAS * Sx[m,g]) * (xs[m,g] * ws[g,n])
//   P[m,g,n]  = sum_{k in g} xq[m,k] * u[k,n]   (u = the stored weight)
//   Sx[m,g]   = sum_{k in g} xq[m,k]
//
//   FMT 4: u biased 4-bit, BIAS 8, the nibble plane (pack4.py: the layout of
//          pack6's hi plane with the nibble holding the value);
//   FMT 8: u the signed int8 weight, BIAS 0, a dense N-minor [K, N] plane.
//
// The integer part is exact (|P - BIAS Sx| < 2^24, so its float is exact
// too) and the scale algebra uses __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA, in the reference's order: the result equals the
// plain PyTorch version (grouped_matmul_plain) bit for bit.
//
// Bound on this card: bytes. At decode (M <= 32) every weight is used by at
// most 32 rows; LLaMA-2-7B streams 0.5 / 1 B per weight (W4 / W8) plus 4 B
// of scale per 128 weights, e.g. 23.1 MB of nibbles + 1.4 MB of scales for
// a 4096 x 11264 W4 matrix, 7.3 us at 3.35 TB/s. The design keeps the
// N-minor plane layouts as stored, so lane n of a warp reads column n: the
// 32 lanes read 32 consecutive bytes of each plane row, one sector per
// load. To put enough bytes in flight, each block splits K across KS warps
// (warp w takes group g0 + w of each round of KS groups) and the per-group
// f32 terms go through shared memory to one owner thread per output, which
// adds them in group order. No tensor cores: dp4a on the unpacked words
// (four K rows per 32-bit word, packed with __byte_perm). Moving these
// formats onto w6ax_matmul.cu's routes (TMA rings of the planes, wgmma for
// prompts) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// 4 byte values (each in the low 8 bits of a word) -> one packed word
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// Rows r .. r + 3 of an N-minor byte plane at column n (p points at row r).
__device__ __forceinline__ uint32_t rows4(const uint8_t* p, int N) {
  return pack4(p[0], p[N], p[2 * (size_t)N], p[3 * (size_t)N]);
}

// The integer partials P - BIAS * Sx of group g for the BM rows of the
// block (x words of the group at xg, row pitch xp words).
template <int FMT, int BM>
__device__ __forceinline__ void group_partials(const uint8_t* __restrict__ p0,
                                               const uint8_t* __restrict__ p1, const int* xg,
                                               int xp, int g, int n, int N, int (&part)[BM]) {
  int dot[BM], sx[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) dot[m] = sx[m] = 0;
  if (FMT == 8) {  // dense signed bytes: rows 4j .. 4j + 3 of the group are word j
    const uint8_t* wp = p0 + (size_t)g * 128 * N + n;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t w = rows4(wp + (size_t)(4 * j) * N, N);
#pragma unroll
      for (int m = 0; m < BM; ++m) dot[m] = __dp4a(xg[m * xp + j], (int)w, dot[m]);
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) part[m] = dot[m];
    return;
  }
  const uint8_t* hp = p0 + (size_t)g * 64 * N + n;
  // half 0: nibble rows 0..31 hold k 0..31 (low nibble) and k 64..95 (high
  // nibble); half 1: nibble rows 32..63 hold k 32..63 and k 96..127.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t hw[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) hw[j] = rows4(hp + (size_t)(32 * half + 4 * j) * N, N);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // the low nibbles hold k = 32*half + 4j .., the high ones k + 64
      const uint32_t ua = hw[j] & 0x0F0F0F0Fu, ub = (hw[j] >> 4) & 0x0F0F0F0Fu;
      const int wa = 8 * half + j, wb = 16 + 8 * half + j;  // word index in group
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int xa = xg[m * xp + wa];
        const int xb = xg[m * xp + wb];
        dot[m] = __dp4a(xa, (int)ua, dot[m]);
        dot[m] = __dp4a(xb, (int)ub, dot[m]);
        sx[m] = __dp4a(xa, 0x01010101, sx[m]);
        sx[m] = __dp4a(xb, 0x01010101, sx[m]);
      }
    }
  }
  constexpr int BIAS = 8;
#pragma unroll
  for (int m = 0; m < BM; ++m) part[m] = dot[m] - BIAS * sx[m];
}

template <int FMT, int KS, int BM>
__global__ void __launch_bounds__(KS * 32)
int_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const uint8_t* __restrict__ p0, const uint8_t* __restrict__ p1,
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
      int part[BM];
      group_partials<FMT, BM>(p0, p1, &xt[0][w * 32], KS * 32, g, n, N, part);
      const float wsc = ws[(size_t)g * N + n];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xsc = (m0 + m < M) ? xs[(size_t)(m0 + m) * G + g] : 0.f;
        terms[w][m][lane] = __fmul_rn(__int2float_rn(part[m]), __fmul_rn(xsc, wsc));
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

template <int FMT, int KS, int BM>
void launch(const void* xq, const void* xs, const void* p0, const void* p1, const void* ws,
            void* out, int M, int N, int K, int out_bf16, cudaStream_t s) {
  dim3 grid((N + 31) / 32, (M + BM - 1) / BM);
  int_matmul_kernel<FMT, KS, BM><<<grid, KS * 32, 0, s>>>(
      (const int8_t*)xq, (const float*)xs, (const uint8_t*)p0, (const uint8_t*)p1,
      (const float*)ws, out, M, N, K, out_bf16);
}

template <int FMT>
int launch_shape(const void* xq, const void* xs, const void* p0, const void* p1, const void* ws,
                 void* out, int M, int N, int K, int out_bf16, int ks, int bm, cudaStream_t s) {
  if (ks == 8 && bm == 8) launch<FMT, 8, 8>(xq, xs, p0, p1, ws, out, M, N, K, out_bf16, s);
  else if (ks == 8 && bm == 4) launch<FMT, 8, 4>(xq, xs, p0, p1, ws, out, M, N, K, out_bf16, s);
  else if (ks == 16 && bm == 8) launch<FMT, 16, 8>(xq, xs, p0, p1, ws, out, M, N, K, out_bf16, s);
  else if (ks == 16 && bm == 4) launch<FMT, 16, 4>(xq, xs, p0, p1, ws, out, M, N, K, out_bf16, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 4 (p0 = nibble plane [K/2, N]) or 8 (p0 = int8 [K, N]); p1 unused; xq int8
// [M, K], xs f32 [M, K/128], ws f32 [K/128, N], out [M, N] bf16 or f32.
// ks: warps splitting K in a block (8: grid kernel, 16: K-tall decode
// shapes); bm: rows per block (4 or 8). Returns cudaGetLastError() after
// the launch.
extern "C" int flexq_int_matmul(int fmt, const void* xq, const void* xs, const void* p0,
                                const void* p1, const void* ws, void* out, int M, int N, int K,
                                int out_bf16, int ks, int bm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 128 != 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (fmt == 4) return launch_shape<4>(xq, xs, p0, p1, ws, out, M, N, K, out_bf16, ks, bm, s);
  if (fmt == 8) return launch_shape<8>(xq, xs, p0, p1, ws, out, M, N, K, out_bf16, ks, bm, s);
  return (int)cudaErrorInvalidValue;
}
