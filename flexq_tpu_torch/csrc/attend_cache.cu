// Causal attention of Lq >= 1 queries over the dense KV cache (bf16, or int8
// with per-(token, head) f32 scales), one warp per query, for Hopper
// (sm_90a), plain C interface.
//
// Serves flexq_tpu/kernels/flash_prefill.py::flash_prefill (K9) for prompts
// of fewer than 64 queries only: longer ones go to flash_prefill.cu's
// tensor-core tiles, and single-query decode (K6, K13) to flash_decode.cu's
// split-KV kernel.
//
//   cache k, v: [L, B, KVH, S, D] bf16 or int8, read at `layer`
//   scales ks, vs: [L, B, KVH, S] f32 (int8 cache only)
//   q: [B, Lq, H, D] bf16; out: [B, Lq, H, D] bf16; lengths: int32 [B]
//   query i of row b sits at pos = lengths[b] - Lq + i and attends keys in
//   (pos - window, pos], from kv head h / (H / KVH).
//
// Numerics follow the TPU kernels: q, K and p are bf16 before their dots
// (int8 K and V upcast exactly), the dots and the softmax statistics are
// f32, and keys are taken in blocks of `bs` (the TPU kernel's block) with the
// online-softmax update
//   s = (q . K) * (1/sqrt(D)) [* ks],  m' = max(m, max s),
//   alpha = exp(m - m'), p = exp(s - m'), l' = l * alpha + sum p,
//   acc' = acc * alpha + bf16(p [* vs]) . V
// per block (the int8 scales folded into the math: never a dequantized copy
// of the cache); the output is acc / max(l, 1e-30). Each P.V sum runs key
// by key in f32 FMAs from zero, as the plain version's matmul does, so a
// short prompt's output rounds as the CPU's does nearly everywhere: on the
// W*Ax prompt path each output goes straight into 6-bit activation codes,
// where one bf16 ulp can flip a code (PERF.md §6).
//
// Bound on this card: bytes (the K and V rows of the keys attended, and
// their scales; the work per byte is a few flops). Design, simple first: one
// warp per (b, h, query), four queries a block; each lane holds D/32 dims of
// q and of the accumulator, so a K or V row is one coalesced warp-wide read;
// the warp reduces each score with shuffles, keeps a block's scores in
// shared memory, and reads only the key blocks in the query's window (blocks
// past the diagonal or before the window start are never read). GQA heads
// re-read their kv head's rows (from L2). Below 64 queries the prompt is
// short (its attention is a small share of the prompt's time), and these
// sums are what the 2e-2 W*Ax parity bounds rely on (ROADMAP Queue 3).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;  // finite -inf stand-in, as in the TPU kernels

template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int i = 0; i < DPL; i += 2) {
    const __nv_bfloat162 two = *reinterpret_cast<const __nv_bfloat162*>(p + i);
    v[i] = __low2float(two);
    v[i + 1] = __high2float(two);
  }
}

// int8 row: exact in f32 (and in bf16, the TPU kernels' upcast)
template <int DPL>
__device__ __forceinline__ void load_row(const int8_t* p, float* v) {
#pragma unroll
  for (int i = 0; i < DPL; i += 2) {
    const char2 two = *reinterpret_cast<const char2*>(p + i);
    v[i] = (float)two.x;
    v[i + 1] = (float)two.y;
  }
}

// T: cache element type (__nv_bfloat16, or int8_t with scales ks / vs)
template <typename T, int DPL, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
attend_cache_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int Lq, int H, int KVH, int S,
                    int window, int bs, float scale) {
  constexpr int D = DPL * 32;
  constexpr bool QUANT = sizeof(T) == 1;
  extern __shared__ float sc_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qi = blockIdx.y * WARPS + warp;
  if (qi >= Lq) return;  // no block-wide barrier below
  float* sc = sc_all + warp * bs;

  const int pos = lengths[b] - Lq + qi;
  const int kvh = h / (H / KVH);
  const size_t row0 = ((size_t)b * KVH + kvh) * S;  // this (b, kv head)'s first key
  // dense row pointers set once (recomputing them from a per-block base
  // slowed the dense Lq > 1 launch measurably)
  const T* kd = kc + row0 * D + lane * DPL;
  const T* vd = vc + row0 * D + lane * DPL;

  float qv[DPL];
  load_row<DPL>(q + (((size_t)b * Lq + qi) * H + h) * D + lane * DPL, qv);
  const int hi_k = min(pos, S - 1);
  const int lo_k = window > 0 ? max(pos - window + 1, 0) : 0;

  float m = NEG, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;

  for (int blk = lo_k / bs; pos >= 0 && blk <= hi_k / bs; ++blk) {
    const int k0 = blk * bs;
    const int nk = min(bs, hi_k - k0 + 1);  // keys past the diagonal: p == 0
    const size_t base = row0 + k0;
    const T* kb = kd + (size_t)k0 * D;
    const T* vb = vd + (size_t)k0 * D;
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float kv[DPL];
      load_row<DPL>(kb + (size_t)j * D, kv);
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) part = fmaf(qv[d], kv[d], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
      if (lane == (j & 31)) {
        float s = part * scale;
        if (QUANT) s = s * ks[base + j];  // K dequant after the dot: (q.K8)*ks
        sc[j] = (k0 + j < lo_k) ? NEG : s;
      }
    }
    __syncwarp();
    float mx = NEG;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, sc[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float ps = 0.f;
    for (int j = lane; j < nk; j += 32) {
      float p = expf(sc[j] - m_new);
      ps += p;
      if (QUANT) p = p * vs[base + j];  // V dequant folded into p: (p*vs).V8
      sc[j] = __bfloat162float(__float2bfloat16_rn(p));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(FULL, ps, off);
    l = l * alpha + ps;
    __syncwarp();
    float pv[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) pv[d] = 0.f;
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float p = sc[j];
      float vv[DPL];
      load_row<DPL>(vb + (size_t)j * D, vv);
#pragma unroll
      for (int d = 0; d < DPL; ++d) pv[d] = fmaf(p, vv[d], pv[d]);
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] = acc[d] * alpha + pv[d];
    m = m_new;
    __syncwarp();  // sc is rewritten by the next block
  }
  const float lsafe = fmaxf(l, 1e-30f);
  __nv_bfloat16* op = out + (((size_t)b * Lq + qi) * H + h) * D + lane * DPL;
#pragma unroll
  for (int d = 0; d < DPL; ++d) op[d] = __float2bfloat16_rn(acc[d] / lsafe);
}

struct Args {
  const void *q, *kc, *vc, *ks, *vs, *lengths;
  void* out;
  int B, Lq, H, KVH, S, window, bs;
  float scale;
};

template <typename T, int DPL, int WARPS>
int launch(const Args& a, cudaStream_t s) {
  dim3 grid(a.B * a.H, (a.Lq + WARPS - 1) / WARPS);
  const size_t smem = (size_t)WARPS * a.bs * sizeof(float);
  attend_cache_kernel<T, DPL, WARPS><<<grid, WARPS * 32, smem, s>>>(
      (const __nv_bfloat16*)a.q, (const T*)a.kc, (const T*)a.vc, (const float*)a.ks,
      (const float*)a.vs, (const int*)a.lengths, (__nv_bfloat16*)a.out, a.Lq, a.H, a.KVH, a.S,
      a.window, a.bs, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 2, 4>(a, s);
    case 128:
      return launch<T, 4, 4>(a, s);
    case 256:
      return launch<T, 8, 4>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// k_layer / v_layer point at cache[layer] ([B, KVH, S, D]); quant = 1 means
// an int8 cache with ks_layer / vs_layer at scales[layer] ([B, KVH, S] f32),
// quant = 0 a bf16 cache (the scale pointers are ignored); window <= 0 means
// none; bs (the key block) divides S and is at most 512. Returns
// cudaGetLastError() after the launch.
extern "C" int flexq_attend_cache(const void* q, const void* k_layer, const void* v_layer,
                                  const void* ks_layer, const void* vs_layer, const void* lengths,
                                  void* out, int B, int Lq, int H, int KVH, int S, int D, int window,
                                  int bs, float scale, int quant, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H % KVH != 0 || S % bs != 0 || bs > 512) return (int)cudaErrorInvalidValue;
  if (quant && (ks_layer == nullptr || vs_layer == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, k_layer, v_layer, ks_layer, vs_layer, lengths, out,
               B, Lq, H, KVH, S, window, bs, scale};
  return quant ? launch_t<int8_t>(a, D, s) : launch_t<__nv_bfloat16>(a, D, s);
}
