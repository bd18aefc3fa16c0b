// Single-query attention over the KV cache (bf16, or int8 with
// per-(token, head) f32 scales), split over the keys, for Hopper (sm_90a),
// plain C interface. One kernel for the dense cache and the page pool: the
// address of a 128-key chunk is a template parameter.
//
// Replaces the TPU kernels of flexq_tpu/kernels/flash_decode.py:
//   flash_decode        (_flash_decode_kernel over the dense cache, K6);
//   flash_decode_paged  (_flash_decode_kernel over a page pool, K13).
//
//   dense cache k, v: [L, B, KVH, S, D] bf16 or int8, read at `layer`;
//     scales ks, vs: [L, B, KVH, S] f32 (int8 cache only); S % 128 == 0.
//     Chunk c of row b, kv head kvh starts at row (b * KVH + kvh) * S + 128 c.
//   pool k, v: [L, P, KVH, PS, D], scales [L, P, KVH, PS]; table: int32
//     [B, MAXPAGES]: key block i of row b is pool page table[b, i]; PS % 128
//     == 0. Chunk c starts at row (table[b, 128 c / PS] * KVH + kvh) * PS +
//     128 c % PS.
//   q: [B, H, D] bf16; out: [B, H, D] bf16; lengths: int32 [B], clipped to
//   [1, S] (S = MAXPAGES * PS for the pool); row b's query sits at
//   pos = lengths[b] - 1 and attends keys in (pos - window, pos] of kv head
//   h / (H / KVH).
//
// Numerics follow the TPU kernel: q, K and p are bf16 before their dots
// (int8 K and V upcast exactly), the dots and the softmax statistics are f32,
// the score is (q . K) * (1/sqrt(D)) [* ks] and bf16(p [* vs]) goes into the
// PV sum (the int8 scales folded into the math). The TPU kernel runs the
// online softmax over one key block at a time (pick_bs(S) keys dense, one
// page paged), from the first block on; here each block runs it over its own
// part of the keys (a split: 128 keys on the main path) from scratch, and
// the last block combines the splits' (m, l, acc) as
// acc_s * exp(m_s - M) / sum l_s * exp(m_s - M). So p is rounded to bf16
// against its split's running max, which is the reference's for a row of at
// most 128 keys and another max past it (ROADMAP Queue 3, "Divergences that
// the tests account for"). Each P.V sum runs key by key in f32 FMAs, one
// thread a dim over all of its split's keys: up to 128 keys (one split)
// that is the order of the plain version's matmul, so the output rounds as
// the CPU's does nearly everywhere where it goes straight into 6-bit codes
// (OPT's 100-token W6Ax prompt; PERF.md §6, "The 6-bit cascade").
//
// Bound on this card: bytes (each K/V row of the keys attended, and their
// scales, read once; a few flops a byte). Design, split-KV in one launch:
// - grid (split, kv head x head group, row): a split is a run of 128-key
//   chunks (one chunk a split while the row's S / 128 <= 64); blocks past a
//   row's length or before its window start exit at once, so the bytes read
//   follow the row's own keys and a short row fills the card with B x KVH
//   blocks, a long one with a block per 128 keys;
// - a block serves up to GM query heads of its kv head (GQA), so each K/V
//   row is read once for all of them;
// - a chunk's K and V rows arrive by cp.async, 16 bytes a thread (16 threads
//   a 128-dim bf16 row), as two groups: the scores run while V lands; rows
//   outside the keys attended are zero-filled, not read; an int8 chunk's
//   scales are one coalesced 16-byte-a-thread copy each;
// - one thread a key for q . K (the 16-byte row words read once, each
//   used for every head of the block), block-wide max and sum, then one
//   thread a dim (two for D = 256) for P . V over the chunk's keys;
// - each split writes (m, l, acc) to scratch; the last block of its (row,
//   kv head, head group) to arrive, found with __threadfence and an atomic
//   counter, combines them and resets the counter to 0 for the next call,
//   so the call stays one launch; a row whose keys fit one split (<= 128
//   keys on the main path) writes its output at once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using cp_async::cp_async16;
using cp_async::cp_async_commit;
using cp_async::cp_async_wait;

constexpr int KC = 128;        // keys of one chunk: one thread a key
constexpr int THREADS = KC;    // 4 warps
constexpr int MAX_SPLITS = 64;

// 16 bytes of a K row as floats (8 bf16 or 16 int8, exact)
template <typename T>
struct Word;
template <>
struct Word<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const void* p, float* v) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __low2float(h[i]);
      v[2 * i + 1] = __high2float(h[i]);
    }
  }
  // DPT neighbouring V values
  template <int DPT>
  static __device__ __forceinline__ void dims(const __nv_bfloat16* p, float* v) {
    if constexpr (DPT == 2) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      v[0] = f.x;
      v[1] = f.y;
    } else {
      v[0] = __bfloat162float(*p);
    }
  }
};
template <>
struct Word<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void load(const void* p, float* v) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = (float)e[i];
  }
  template <int DPT>
  static __device__ __forceinline__ void dims(const int8_t* p, float* v) {
    if constexpr (DPT == 2) {
      const char2 c = *reinterpret_cast<const char2*>(p);
      v[0] = (float)c.x;
      v[1] = (float)c.y;
    } else {
      v[0] = (float)*p;
    }
  }
};

template <typename T, int D, int GM>
struct Smem {
  static constexpr int LD = D + 16 / (int)sizeof(T);  // row stride: 16 bytes of pad, no bank conflicts
  static constexpr size_t kv = (size_t)KC * LD * sizeof(T);  // one of K, V
  static constexpr size_t bytes = 2 * kv + (size_t)GM * D * 4 + (size_t)GM * KC * 4 + 2 * KC * 4 +
                                  (size_t)GM * MAX_SPLITS * 4;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// T: cache element type; D: head dim; GM: query heads a block serves at
// most; PAGED: chunk addresses through the page table (else the dense
// cache, read as a pool of B pages of S keys with table[b, 0] = b).
template <typename T, int D, int GM, bool PAGED>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ lengths,
                    const int* __restrict__ table, int max_pages, int ps,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ counters, int H, int KVH, int window, float scale, int cps) {
  using L = Smem<T, D, GM>;
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int LD = L::LD;
  constexpr int WN = Word<T>::N;            // elements of a 16-byte word
  constexpr int DPT = D > THREADS ? 2 : 1;  // dims a thread sums P . V for
  static_assert(D == 64 || D == 128 || D == 256, "D in {64, 128, 256}");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [KC][LD]
  T* Vs = reinterpret_cast<T*>(smem + L::kv);
  float* qs = reinterpret_cast<float*>(smem + 2 * L::kv);  // [GM][D]
  float* pb = qs + GM * D;                                 // [GM][KC]: scores, then bf16(p [* vs])
  float* kss = pb + GM * KC;                               // [KC]
  float* vss = kss + KC;                                   // [KC]
  float* wts = vss + KC;                                   // [GM][MAX_SPLITS]: the combine's weights
  __shared__ float red[GM][THREADS / 32];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = H / KVH, HG = (G + GM - 1) / GM;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y / HG, g0 = (blockIdx.y % HG) * GM, gn = min(GM, G - g0);
  const int b = blockIdx.z;
  const int S = max_pages * ps;
  const int len = min(max(lengths[b], 1), S);
  const int lo = window > 0 ? max(len - window, 0) : 0;  // keys lo .. len - 1
  const int s_first = lo / KC / cps, s_last = (len - 1) / KC / cps;
  if (split < s_first || split > s_last) return;
  const int c_begin = max(split * cps, lo / KC), c_end = min(split * cps + cps, (len - 1) / KC + 1);

  for (int e = tid; e < GM * D; e += THREADS) {
    const int g = e / D;
    qs[e] = g < gn ? __bfloat162float(q[((size_t)b * H + kvh * G + g0 + g) * D + e % D]) : 0.f;
  }

  float m[GM], l[GM], acc[GM][DPT];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[g][e] = 0.f;
  }
  const int d0 = tid * DPT;  // the PV sum: dims d0 .. d0 + DPT - 1 (threads past D idle there)

  for (int c = c_begin; c < c_end; ++c) {
    const int key0 = c * KC;
    const int page = PAGED ? table[(size_t)b * max_pages + key0 / ps] : b;
    const size_t base = ((size_t)page * KVH + kvh) * ps + key0 % ps;  // the chunk's first row
    const int k_lo = max(lo - key0, 0), k_hi = min(len - 1 - key0, KC - 1);  // the chunk's keys attended
    constexpr int CPR = D / WN;  // 16-byte words of a row
    for (int w = tid; w < KC * CPR; w += THREADS) {
      const int r = w / CPR, col = (w % CPR) * WN;
      cp_async16(Ks + r * LD + col, kc + (base + r) * D + col, r >= k_lo && r <= k_hi ? 16 : 0);
    }
    if (QUANT && tid < KC / 4) cp_async16(kss + tid * 4, ks + base + tid * 4, 16);
    cp_async_commit();
    for (int w = tid; w < KC * CPR; w += THREADS) {
      const int r = w / CPR, col = (w % CPR) * WN;
      cp_async16(Vs + r * LD + col, vc + (base + r) * D + col, r >= k_lo && r <= k_hi ? 16 : 0);
    }
    if (QUANT && tid < KC / 4) cp_async16(vss + tid * 4, vs + base + tid * 4, 16);
    cp_async_commit();
    cp_async_wait<1>();  // K has landed
    __syncthreads();

    // scores: thread tid is key tid of the chunk
    const bool ok = tid >= k_lo && tid <= k_hi;
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
#pragma unroll 4
    for (int col = 0; col < D; col += WN) {
      float kv[WN];
      Word<T>::load(Ks + tid * LD + col, kv);
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < WN; ++e) s[g] = fmaf(qs[g * D + col + e], kv[e], s[g]);
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float v = s[g] * scale;
      if (QUANT) v = v * kss[tid];  // K dequant after the dot: (q.K8)*ks
      s[g] = ok ? v : -INFINITY;
      const float mx = warp_max(s[g]);
      if (lane == 0) red[g][warp] = mx;
    }
    __syncthreads();
    float alpha[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = red[g][0];
#pragma unroll
      for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, red[g][w]);
      const float mn = fmaxf(m[g], mx);  // finite: the chunk holds a key attended
      alpha[g] = expf(m[g] - mn);
      m[g] = mn;
      s[g] = expf(s[g] - mn);  // p; 0 off the keys attended
    }
    __syncthreads();  // red is read by all before it is rewritten
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float sum = warp_sum(s[g]);
      if (lane == 0) red[g][warp] = sum;
    }
    cp_async_wait<0>();  // V and its scales have landed
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float sum = red[g][0];
#pragma unroll
      for (int w = 1; w < THREADS / 32; ++w) sum += red[g][w];
      l[g] = l[g] * alpha[g] + sum;
      float p = s[g];
      if (QUANT) p = ok ? p * vss[tid] : 0.f;  // V dequant folded into p: (p*vs).V8
      pb[g * KC + tid] = __bfloat162float(__float2bfloat16_rn(p));
    }
    __syncthreads();
    // P . V key by key over the chunk's keys attended, rescaled by alpha first
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[g][e] *= alpha[g];
    if (d0 < D) {
      for (int j = k_lo; j <= k_hi; ++j) {
        float v[DPT];
        Word<T>::template dims<DPT>(Vs + j * LD + d0, v);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float p = pb[g * KC + j];
#pragma unroll
          for (int e = 0; e < DPT; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
        }
      }
    }
    __syncthreads();  // the next chunk's copies overwrite K, V, pb
  }

  const size_t slot = ((size_t)b * gridDim.y + blockIdx.y) * nsplit;  // this (row, kv head, head group)
  constexpr int PW = D + 2;  // a partial: acc[D], m, l
  const bool only = s_first == s_last;  // the row's one split: the output directly, as the combine would give it
  if (d0 < D) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= gn) break;
      if (only) {
        const float ls = fmaxf(l[g], 1e-30f);
        __nv_bfloat16* o = out + ((size_t)b * H + kvh * G + g0 + g) * D + d0;
#pragma unroll
        for (int e = 0; e < DPT; ++e) o[e] = __float2bfloat16_rn(acc[g][e] / ls);
        continue;
      }
      float* pp = part + ((slot + split) * GM + g) * PW;
#pragma unroll
      for (int e = 0; e < DPT; ++e) pp[d0 + e] = acc[g][e];
      if (tid == 0) {
        pp[D] = m[g];
        pp[D + 1] = l[g];
      }
    }
  }
  if (only) return;
  __threadfence();  // the partial is visible to the block that combines
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + (size_t)b * gridDim.y + blockIdx.y;
    is_last = atomicAdd(cnt, 1) == s_last - s_first;
    if (is_last) *cnt = 0;  // ready for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // combine splits s_first .. s_last: out = sum acc_s w_s / sum l_s w_s,
  // w_s = exp(m_s - M), M = max m_s
  const int ns = s_last - s_first + 1;
  if (tid < gn) {
    const int g = tid;
    float M = -INFINITY;
    for (int sp = 0; sp < ns; ++sp) M = fmaxf(M, __ldcg(part + ((slot + s_first + sp) * GM + g) * PW + D));
    float lsum = 0.f;
    for (int sp = 0; sp < ns; ++sp) {
      const float* pp = part + ((slot + s_first + sp) * GM + g) * PW;
      const float w = expf(__ldcg(pp + D) - M);
      wts[g * MAX_SPLITS + sp] = w;
      lsum += __ldcg(pp + D + 1) * w;
    }
    red[g][0] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < gn * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float o = 0.f;
    for (int sp = 0; sp < ns; ++sp)
      o = fmaf(__ldcg(part + ((slot + s_first + sp) * GM + g) * PW + d), wts[g * MAX_SPLITS + sp], o);
    out[((size_t)b * H + kvh * G + g0 + g) * D + d] = __float2bfloat16_rn(o / red[g][0]);
  }
}

struct Args {
  const void *q, *kc, *vc, *ks, *vs, *lengths, *table;
  void *out, *part, *counters;
  int B, H, KVH, D, max_pages, ps, window;
  float scale;
  long long part_size;
};

// The launch's geometry, the one place it is computed: GM query heads a
// block (1 without GQA, else 8), HG = ceil(G / GM) blocks a kv head, a split
// of cps 128-key chunks (at most MAX_SPLITS splits a row), nsplit splits.
struct Geometry {
  int gm, hg, cps, nsplit;
};

Geometry geometry(int H, int KVH, int keys) {
  Geometry g;
  g.gm = H == KVH ? 1 : 8;
  g.hg = (H / KVH + g.gm - 1) / g.gm;
  const int chunks = keys / KC;
  g.cps = (chunks + MAX_SPLITS - 1) / MAX_SPLITS;
  g.nsplit = (chunks + g.cps - 1) / g.cps;
  return g;
}

long long scratch_floats(int B, int H, int KVH, int D, int keys) {
  const Geometry g = geometry(H, KVH, keys);
  return (long long)B * KVH * g.hg * g.nsplit * g.gm * (D + 2);  // a split's (acc[D], m, l) per head
}

template <typename T, int D, int GM, bool PAGED>
int launch(const Args& a, cudaStream_t s) {
  auto kern = flash_decode_kernel<T, D, GM, PAGED>;
  const size_t smem = Smem<T, D, GM>::bytes;
  static bool attr_set = false;  // once per instance: above 48 KB only after this
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int keys = a.max_pages * a.ps;
  const Geometry g = geometry(a.H, a.KVH, keys);
  if (g.gm != GM || a.part_size < scratch_floats(a.B, a.H, a.KVH, D, keys)) return (int)cudaErrorInvalidValue;
  dim3 grid(g.nsplit, a.KVH * g.hg, a.B);
  kern<<<grid, THREADS, smem, s>>>((const __nv_bfloat16*)a.q, (const T*)a.kc, (const T*)a.vc,
                                   (const float*)a.ks, (const float*)a.vs, (const int*)a.lengths,
                                   (const int*)a.table, a.max_pages, a.ps, (__nv_bfloat16*)a.out,
                                   (float*)a.part, (int*)a.counters, a.H, a.KVH, a.window, a.scale, g.cps);
  return (int)cudaGetLastError();
}

template <typename T, int GM, bool PAGED>
int launch_d(const Args& a, cudaStream_t s) {
  switch (a.D) {
    case 64:
      return launch<T, 64, GM, PAGED>(a, s);
    case 128:
      return launch<T, 128, GM, PAGED>(a, s);
    case 256:
      return launch<T, 256, GM, PAGED>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool PAGED>
int launch_all(const Args& a, int quant, cudaStream_t s) {
  const bool gqa = geometry(a.H, a.KVH, a.max_pages * a.ps).gm != 1;
  if (quant) return gqa ? launch_d<int8_t, 8, PAGED>(a, s) : launch_d<int8_t, 1, PAGED>(a, s);
  return gqa ? launch_d<__nv_bfloat16, 8, PAGED>(a, s) : launch_d<__nv_bfloat16, 1, PAGED>(a, s);
}

bool bad_args(int H, int KVH, int ps, int max_pages) {
  return KVH < 1 || H % KVH != 0 || ps % KC != 0 || ps < KC || max_pages < 1;
}

}  // namespace

// k_layer / v_layer point at the cache's layer: the dense cache's
// [B, KVH, S, D] (table null, max_pages 1, PS = S) or the pool's
// [P, KVH, PS, D] read through table (int32 [B, max_pages]); quant = 1 means
// an int8 cache with ks_layer / vs_layer at its scales' layer ([B or P, KVH,
// PS] f32), quant = 0 a bf16 cache; window <= 0 means none; PS % 128 == 0.
// part: f32 scratch of part_size floats and counters: int32, zero before the
// first call (each call leaves them zero), at least the sizes
// flexq_flash_decode_sizes gives. Returns cudaGetLastError() after the
// launch.
extern "C" int flexq_flash_decode(const void* q, const void* k_layer, const void* v_layer, const void* ks_layer,
                                  const void* vs_layer, const void* lengths, const void* table, int max_pages,
                                  void* out, void* part, long long part_size, void* counters, int B, int H, int KVH,
                                  int PS, int D, int window, float scale, int quant, void* stream) {
  if (bad_args(H, KVH, PS, max_pages) || (table == nullptr && max_pages != 1)) return (int)cudaErrorInvalidValue;
  if (quant && (ks_layer == nullptr || vs_layer == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, k_layer, v_layer, ks_layer, vs_layer, lengths, table, out, part, counters,
               B, H, KVH, D, max_pages, PS, window, scale, part_size};
  cudaStream_t s = (cudaStream_t)stream;
  return table != nullptr ? launch_all<true>(a, quant, s) : launch_all<false>(a, quant, s);
}

// The sizes a launch needs for these arguments (the dense cache: max_pages
// = 1, PS = S): *part_floats floats of f32 scratch and *counters int32
// arrival counters (one per row, kv head and head group). Returns 0, or
// cudaErrorInvalidValue for arguments that flexq_flash_decode refuses.
extern "C" int flexq_flash_decode_sizes(int B, int H, int KVH, int PS, int D, int max_pages,
                                        long long* part_floats, int* counters) {
  if (bad_args(H, KVH, PS, max_pages)) return (int)cudaErrorInvalidValue;
  *part_floats = scratch_floats(B, H, KVH, D, max_pages * PS);
  *counters = B * KVH * geometry(H, KVH, max_pages * PS).hg;
  return 0;
}
