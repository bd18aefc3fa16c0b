// Causal attention of Lq >= 1 queries over the dense bf16 KV cache, for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels flexq_tpu/kernels/flash_decode.py::flash_decode
// (_flash_decode_kernel, the Lq == 1 case) and
// flexq_tpu/kernels/flash_prefill.py::flash_prefill (_flash_prefill_kernel)
// for a bf16 cache: on such a cache the two compute the same function.
//
//   cache  k, v: [L, B, KVH, S, D] bf16, read at `layer`
//   q: [B, Lq, H, D] bf16; out: [B, Lq, H, D] bf16; lengths: int32 [B]
//   query i of row b sits at pos = lengths[b] - Lq + i (decode clips
//   lengths[b] to [1, S] first) and attends keys in (pos - window, pos],
//   from kv head h / (H / KVH).
//
// Numerics follow the TPU kernels: q, K and p are bf16 before their dots,
// the dots and the softmax statistics are f32, and keys are taken in blocks
// of `bs` (the TPU kernel's block) with the online-softmax update
//   m' = max(m, max s), alpha = exp(m - m'), p = exp(s - m'),
//   l' = l * alpha + sum p, acc' = acc * alpha + bf16(p) . V
// per block; the output is acc / max(l, 1e-30).
//
// Bound on this card: bytes (the K and V rows of the keys attended; the
// work per byte is a few flops). Design, simple first: one warp per
// (b, h, query); each lane holds D/32 dims of q and of the accumulator, so
// a K or V row is one coalesced warp-wide read; the warp reduces each score
// with shuffles, keeps a block's scores in shared memory, and reads only the
// key blocks in the query's window (blocks past the diagonal or before the
// window start are never read). GQA heads re-read their kv head's rows
// (from L2); sharing them across a block's warps is later work.

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

template <int DPL, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
attend_cache_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int Lq, int H, int KVH, int S,
                    int window, int bs, float scale, int clip_len) {
  constexpr int D = DPL * 32;
  extern __shared__ float sc_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qi = blockIdx.y * WARPS + warp;
  if (qi >= Lq) return;  // no block-wide barrier below
  float* sc = sc_all + warp * bs;

  int len = lengths[b];
  if (clip_len) len = min(max(len, 1), S);
  const int pos = len - Lq + qi;
  const int kvh = h / (H / KVH);
  const size_t head = ((size_t)b * KVH + kvh) * S * D + lane * DPL;
  const __nv_bfloat16* kb = kc + head;
  const __nv_bfloat16* vb = vc + head;

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
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float kv[DPL];
      load_row<DPL>(kb + (size_t)(k0 + j) * D, kv);
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) part = fmaf(qv[d], kv[d], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
      if (lane == (j & 31)) sc[j] = (k0 + j < lo_k) ? NEG : part * scale;
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
      const float p = expf(sc[j] - m_new);
      ps += p;
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
      load_row<DPL>(vb + (size_t)(k0 + j) * D, vv);
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

template <int DPL, int WARPS>
int launch(const void* q, const void* kc, const void* vc, const void* lengths, void* out, int B,
           int Lq, int H, int KVH, int S, int window, int bs, float scale, int clip_len,
           cudaStream_t s) {
  dim3 grid(B * H, (Lq + WARPS - 1) / WARPS);
  const size_t smem = (size_t)WARPS * bs * sizeof(float);
  attend_cache_kernel<DPL, WARPS><<<grid, WARPS * 32, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kc, (const __nv_bfloat16*)vc,
      (const int*)lengths, (__nv_bfloat16*)out, Lq, H, KVH, S, window, bs, scale, clip_len);
  return (int)cudaGetLastError();
}

template <int DPL>
int launch_d(const void* q, const void* kc, const void* vc, const void* lengths, void* out,
             int B, int Lq, int H, int KVH, int S, int window, int bs, float scale,
             int clip_len, cudaStream_t s) {
  if (Lq == 1)
    return launch<DPL, 1>(q, kc, vc, lengths, out, B, Lq, H, KVH, S, window, bs, scale,
                          clip_len, s);
  return launch<DPL, 4>(q, kc, vc, lengths, out, B, Lq, H, KVH, S, window, bs, scale, clip_len,
                        s);
}

}  // namespace

// k_layer / v_layer point at cache[layer] ([B, KVH, S, D]); window <= 0 means
// none; clip_len = 1 clips lengths to [1, S] (decode). Returns
// cudaGetLastError() after the launch.
extern "C" int flexq_attend_cache(const void* q, const void* k_layer, const void* v_layer,
                                  const void* lengths, void* out, int B, int Lq, int H,
                                  int KVH, int S, int D, int window, int bs, float scale,
                                  int clip_len, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H % KVH != 0 || S % bs != 0 || bs > 512) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_d<2>(q, k_layer, v_layer, lengths, out, B, Lq, H, KVH, S, window, bs, scale,
                         clip_len, s);
    case 128:
      return launch_d<4>(q, k_layer, v_layer, lengths, out, B, Lq, H, KVH, S, window, bs, scale,
                         clip_len, s);
    case 256:
      return launch_d<8>(q, k_layer, v_layer, lengths, out, B, Lq, H, KVH, S, window, bs, scale,
                         clip_len, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
