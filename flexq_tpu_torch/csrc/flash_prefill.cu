// Causal attention of Lq >= 1 queries over the dense KV cache (bf16, or int8
// with per-(token, head) f32 scales) on the tensor cores, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel flexq_tpu/kernels/flash_prefill.py::flash_prefill
// (_flash_prefill_kernel, K9) for a bf16 or an int8 cache, for prompts of
// 64 queries or more: kernels/flash_prefill.py sends shorter ones to
// attend_cache.cu's warp-per-query kernel, whose P.V sums run key by key as
// the CPU's plain version does (LLaMA's short W*Ax prompts are held to it at
// 2e-2 of max |logit|; ROADMAP Queue 3 says what would retire the split).
//
//   cache k, v: [L, B, KVH, S, D] bf16 or int8, read at `layer`
//   scales ks, vs: [L, B, KVH, S] f32 (int8 cache only)
//   q: [B, Lq, H, D] bf16; out: [B, Lq, H, D] bf16; lengths: int32 [B]
//   query i of row b sits at pos = lengths[b] - Lq + i and attends keys in
//   (pos - window, pos] of kv head h / (H / KVH); a query with pos < 0
//   attends nothing and reads 0.
//
// Numerics follow the TPU kernel: q, K and p are bf16 before their dots
// (int8 K and V upcast exactly), the dots and the softmax statistics are
// f32, and each key block of bs = pick_bs(S) keys (up to 512, aligned at
// multiples of bs) takes the online-softmax update
//   s = (q . K) * (1/sqrt(D)) [* ks],  m' = max(m, max s over the block),
//   alpha = exp(m - m'), p = exp(s - m'), l' = l * alpha + sum p,
//   acc' = acc * alpha + bf16(p [* vs]) . V
// (the int8 scales folded into the math: never a dequantized copy of the
// cache); the output is acc / max(l, 1e-30). So p is rounded to bf16
// against the same max as in the TPU kernel and the plain version, and the
// kernel parts from them only in the order of its f32 sums: OPT's W*Ax
// prompts quantize this output to 6-bit codes at once, and p rounded
// against a running max every 64 keys parted over a hundred times as many
// bf16 outputs from the CPU's at Lq = 512 (PERF.md §6).
//
// Bound on this card: bytes, once the dots run on the tensor cores (at
// Lq = 512 over 512 keys, B = 4, H = 32, D = 128: 34 MB of K/V, 0.020 ms at
// 3.35 TB/s; 8.6 GFLOP of causal dots, 0.009 ms at the bf16 tensor-core
// peak, about 15x that on the CUDA cores). Design (FlashAttention-2's, on
// mma.sync, with the TPU kernel's key blocks):
// - one block of 4 warps per (kv head, row, tile of 64 query rows); a tile's
//   rows are (query, query head) pairs of one kv head, query-major, so for
//   GQA one K/V tile feeds all G query heads of its kv head; each warp owns
//   16 rows;
// - the block walks only the key tiles (BK = 64 keys; 32 at D = 256) between
//   its oldest query's window start and its youngest query's diagonal; a
//   warp skips the tiles that none of its rows attends; the grid runs the
//   last (longest) query tiles first;
// - a key block of more than one tile is walked twice: pass 0 reads its K
//   tiles and takes each row's max over the block (Q.K^T only), pass 1
//   reads K and V again (from L2, mostly), recomputes the same scores and
//   takes the update above; a block cut to one tile (at a window start, or
//   a diagonal just past a block's start) runs pass 1 only. Recomputing Q.K^T keeps the scores out of shared memory
//   (a 64 x 512 f32 block would hold one block an SM);
// - Q.K^T and P.V run as mma.sync m16n8k16 bf16 -> f32, operands loaded with
//   ldmatrix from shared memory (rows padded by 16 bytes: ldmatrix's eight
//   rows fall on distinct banks); P goes from the score accumulators to the
//   PV operand in registers, as FlashAttention-2 does;
// - K/V tiles are double-buffered with cp.async (pass 0 copies K only);
//   rows outside the block's key range are zero-filled, not read;
// - an int8 tile lands in a staging buffer and is converted to bf16 (exact)
//   on its way into the tile the MMAs read; its scales arrive as whole
//   vectors per tile (16-byte copies);
// - the softmax statistics live in registers: each thread holds two rows'
//   max (shared by the 4 threads of a quad) and its own partial row sums.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using cp_async::cp_async16;
using cp_async::cp_async_commit;
using cp_async::cp_async_wait;
using cp_async::smem_u32;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16 * WARPS;  // query rows of a block

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b over one m16n8k16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 int8 values -> 16 bf16 (exact), as two 16-byte words
__device__ __forceinline__ void int8x16_to_bf16(const int4 v, uint4& lo, uint4& hi) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&v);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack_bf16((float)e[2 * i], (float)e[2 * i + 1]);
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename T, int D, int BK>
struct Smem {
  static constexpr bool QUANT = sizeof(T) == 1;
  static constexpr int LD = D + 8;    // bf16 row stride (elements)
  static constexpr int LD8 = D + 16;  // int8 staging row stride (bytes)
  static constexpr int STAGES = QUANT ? 1 : 2;  // bf16 K/V tiles the MMAs read
  static constexpr size_t bytes = (size_t)(BQ + 2 * STAGES * BK) * LD * 2 +
                                  (QUANT ? (size_t)2 * 2 * BK * LD8 + 2 * 2 * BK * sizeof(float) : 0);
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out, int Lq, int H, int KVH, int S, int window,
                     int bs, float scale) {
  using L = Smem<T, D, BK>;
  constexpr bool QUANT = L::QUANT;
  constexpr int LD = L::LD, LD8 = L::LD8;
  constexpr int CH = D / 8;    // 16-byte chunks of a bf16 row
  constexpr int CH8 = D / 16;  // 16-byte chunks of an int8 row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                             // [STAGES][BK][LD]
  __nv_bfloat16* Vs = Ks + L::STAGES * BK * LD;
  int8_t* K8 = reinterpret_cast<int8_t*>(Vs + L::STAGES * BK * LD);  // int8: [2][BK][LD8]
  int8_t* V8 = K8 + 2 * BK * LD8;
  float* KSs = reinterpret_cast<float*>(V8 + 2 * BK * LD8);  // int8: [2][BK]
  float* VSs = KSs + 2 * BK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = H / KVH, rows = Lq * G;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the last query tiles first
  const int pos0 = lengths[b] - Lq;                   // position of query 0
  const int first_pos = pos0 + r0 / G;
  const int last_pos = pos0 + (min(r0 + BQ, rows) - 1) / G;
  const int hi = min(last_pos, S - 1);
  const int lo = window > 0 ? max(first_pos - window + 1, 0) : 0;
  const int t_lo = lo / BK;
  const int t_hi = hi < lo ? t_lo - 1 : hi / BK;  // the key tiles t_lo .. t_hi
  const int TB = bs / BK;                          // tiles of a key block

  // the key block of tile t, cut to t_lo .. t_hi: its first and last tile
  auto blk_first = [&](int t) { return max(t_lo, t / TB * TB); };
  auto blk_last = [&](int t) { return min(t_hi, t / TB * TB + TB - 1); };
  // the step after (t, pass): the block's next tile, or its pass 1, or the
  // next block (in pass 0 unless it is one tile)
  auto next_step = [&](int& t, int& pass) {
    if (t < blk_last(t)) {
      ++t;
    } else if (pass == 0) {
      t = blk_first(t);
      pass = 1;
    } else {
      ++t;
      pass = t <= t_hi && t < blk_last(t) ? 0 : 1;
    }
  };

  const size_t row0 = ((size_t)b * KVH + kvh) * S;  // this (row, kv head)'s first key
  const T* kb = kc + row0 * D;
  const T* vb = vc + row0 * D;

  // Q tile: rows past the last (query, head) pair are zeros
  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8, R = min(r0 + r, rows - 1);
    const __nv_bfloat16* src = q + (((size_t)b * Lq + R / G) * H + kvh * G + R % G) * D + col;
    cp_async16(Qs + r * LD + col, src, r0 + r < rows ? 16 : 0);
  }
  // tile t into stage st: K (and its scales) in both passes, V in pass 1
  auto load_tile = [&](int t, int st, int pass) {
    const int k0 = t * BK;
    if (!QUANT) {
      for (int c = tid; c < BK * CH; c += THREADS) {
        const int r = c / CH, col = (c % CH) * 8, key = k0 + r;
        const size_t off = (size_t)key * D + col;
        const int n = key >= lo && key <= hi ? 16 : 0;
        cp_async16(Ks + (st * BK + r) * LD + col, kb + off, n);
        if (pass) cp_async16(Vs + (st * BK + r) * LD + col, vb + off, n);
      }
    } else {
      for (int c = tid; c < BK * CH8; c += THREADS) {
        const int r = c / CH8, col = (c % CH8) * 16, key = k0 + r;
        const size_t off = (size_t)key * D + col;
        const int n = key >= lo && key <= hi ? 16 : 0;
        cp_async16(K8 + (st * BK + r) * LD8 + col, kb + off, n);
        if (pass) cp_async16(V8 + (st * BK + r) * LD8 + col, vb + off, n);
      }
      if (tid < (pass ? BK / 2 : BK / 4)) {  // the tile's scales: BK / 4 16-byte words each
        const bool kside = tid < BK / 4;
        const int w = (kside ? tid : tid - BK / 4) * 4;
        cp_async16((kside ? KSs : VSs) + st * BK + w, (kside ? ks : vs) + row0 + k0 + w, 16);
      }
    }
  };
  int t = t_lo, pass = t_lo < blk_last(t_lo) ? 0 : 1;
  if (t <= t_hi) load_tile(t, 0, pass);
  cp_async_commit();

  // this thread's two rows of the warp's 16: g8 and g8 + 8
  const int g8 = lane >> 2, t4 = lane & 3;
  int rpos[2], rlo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = r0 + warp * 16 + g8 + 8 * i;
    rpos[i] = R < rows ? pos0 + R / G : -1;  // -1: attends nothing
    rlo[i] = window > 0 ? rpos[i] - window + 1 : 0;
  }
  const int wr = r0 + warp * 16;  // the warp's key range, to skip tiles it does not attend
  const int w_hi = wr < rows ? pos0 + (min(wr + 16, rows) - 1) / G : -1;
  const int w_lo = window > 0 ? pos0 + wr / G - window + 1 : 0;

  // m: the running max before this block; mb: the max over this block's
  // keys; mu: the max that this block's p is taken against
  float m[2] = {-INFINITY, -INFINITY}, mb[2] = {-INFINITY, -INFINITY}, mu[2] = {0.f, 0.f};
  float l[2] = {0.f, 0.f};
  bool fresh = true;  // the warp has taken no tile of this block's pass 1 yet
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int st = 0; t <= t_hi; st ^= 1) {
    const int k0 = t * BK;
    int tn = t, pn = pass;
    next_step(tn, pn);
    if (tn <= t_hi) load_tile(tn, st ^ 1, pn);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (QUANT ? 0 : st) * BK * LD;
    const __nv_bfloat16* Vt = Vs + (QUANT ? 0 : st) * BK * LD;
    if (QUANT) {  // int8 staging -> the bf16 tiles
      for (int c = tid; c < BK * CH8; c += THREADS) {
        const int r = c / CH8, col = (c % CH8) * 16;
        uint4 a, z;
        int8x16_to_bf16(*reinterpret_cast<const int4*>(K8 + (st * BK + r) * LD8 + col), a, z);
        *reinterpret_cast<uint4*>(Ks + r * LD + col) = a;
        *reinterpret_cast<uint4*>(Ks + r * LD + col + 8) = z;
        if (!pass) continue;
        int8x16_to_bf16(*reinterpret_cast<const int4*>(V8 + (st * BK + r) * LD8 + col), a, z);
        *reinterpret_cast<uint4*>(Vs + r * LD + col) = a;
        *reinterpret_cast<uint4*>(Vs + r * LD + col + 8) = z;
      }
      __syncthreads();
    }
    if (k0 <= w_hi && k0 + BK - 1 >= w_lo) {
      // S = Q . K^T: the warp's 16 rows x BK keys
      float sc[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
          mma16816(sc[2 * np], a, kf[0], kf[1]);
          mma16816(sc[2 * np + 1], a, kf[2], kf[3]);
        }
      }
      // scale, mask, row max (accumulator element e: row g8 + 8 * (e >> 1), key 2 * t4 + (e & 1))
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kt = j * 8 + t4 * 2 + (e & 1), key = k0 + kt;
          float s = sc[j][e] * scale;
          if (QUANT) s = s * KSs[st * BK + kt];  // K dequant after the dot: (q.K8)*ks
          s = (key <= rpos[i] && key >= rlo[i]) ? s : -INFINITY;
          sc[j][e] = s;
          mx[i] = fmaxf(mx[i], s);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mb[i] = fmaxf(mb[i], mx[i]);  // pass 1 of a block walked twice: the same scores, mb as it was
      }
      if (pass) {
        if (fresh) {  // the block's max is known: rescale once, before its first P.V
          float alpha[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float mn = fmaxf(m[i], mb[i]);
            mu[i] = mn == -INFINITY ? 0.f : mn;  // no key yet: p and alpha are 0, never NaN
            alpha[i] = expf(m[i] - mu[i]);
            m[i] = mn;
            l[i] *= alpha[i];
          }
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[j][0] *= alpha[0];
            o[j][1] *= alpha[0];
            o[j][2] *= alpha[1];
            o[j][3] *= alpha[1];
          }
          fresh = false;
        }
        // p, the row sums, and P as the PV product's A operand (bf16)
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = expf(sc[j][e] - mu[e >> 1]);
            l[e >> 1] += p;
            if (QUANT) p = p > 0.f ? p * VSs[st * BK + j * 8 + t4 * 2 + (e & 1)] : 0.f;  // (p*vs).V8
            sc[j][e] = p;
          }
          pa[j >> 1][(j & 1) * 2] = pack_bf16(sc[j][0], sc[j][1]);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[j][2], sc[j][3]);
        }
        // O += P . V
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt) {
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t vf[4];
            ldsm_x4_t(vf, Vt + (kt * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
            mma16816(o[2 * dp], pa[kt], vf[0], vf[1]);
            mma16816(o[2 * dp + 1], pa[kt], vf[2], vf[3]);
          }
        }
      }
    }
    if (pass && t == blk_last(t)) {  // the block is done: the next takes its own max
      mb[0] = mb[1] = -INFINITY;
      fresh = true;
    }
    t = tn;
    pass = pn;
    __syncthreads();  // the next step's copies overwrite this tile's buffers
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int R = r0 + warp * 16 + g8 + 8 * i;
    if (R >= rows) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* op = out + (((size_t)b * Lq + R / G) * H + kvh * G + R % G) * D + t4 * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(o[j][2 * i] / lsafe, o[j][2 * i + 1] / lsafe);
  }
}

struct Args {
  const void *q, *kc, *vc, *ks, *vs, *lengths;
  void* out;
  int B, Lq, H, KVH, S, window, bs;
  float scale;
};

template <typename T, int D, int BK>
int launch(const Args& a, cudaStream_t s) {
  auto kern = flash_prefill_kernel<T, D, BK>;
  const size_t smem = Smem<T, D, BK>::bytes;
  static bool attr_set = false;  // once per instance: above 48 KB only after this
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int tiles = (a.Lq * (a.H / a.KVH) + BQ - 1) / BQ;
  dim3 grid(a.KVH, a.B, tiles);
  kern<<<grid, THREADS, smem, s>>>((const __nv_bfloat16*)a.q, (const T*)a.kc, (const T*)a.vc,
                                   (const float*)a.ks, (const float*)a.vs, (const int*)a.lengths,
                                   (__nv_bfloat16*)a.out, a.Lq, a.H, a.KVH, a.S, a.window, a.bs, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64, 64>(a, s);
    case 128:
      return launch<T, 128, 64>(a, s);
    case 256:  // the accumulator is 128 registers a thread: half the key tile
      return launch<T, 256, 32>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// k_layer / v_layer point at cache[layer] ([B, KVH, S, D]); quant = 1 means
// an int8 cache with ks_layer / vs_layer at scales[layer] ([B, KVH, S] f32),
// quant = 0 a bf16 cache (the scale pointers are ignored); window <= 0 means
// none; bs (the key block: a multiple of 128 that divides S, at most 512)
// is pick_bs(S). Returns cudaGetLastError() after the launch.
extern "C" int flexq_flash_prefill(const void* q, const void* k_layer, const void* v_layer,
                                   const void* ks_layer, const void* vs_layer, const void* lengths,
                                   void* out, int B, int Lq, int H, int KVH, int S, int D, int window,
                                   int bs, float scale, int quant, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Lq < 1 || KVH < 1 || H % KVH != 0 || bs < 128 || bs > 512 || bs % 128 != 0 || S % bs != 0)
    return (int)cudaErrorInvalidValue;
  if (quant && (ks_layer == nullptr || vs_layer == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, k_layer, v_layer, ks_layer, vs_layer, lengths, out, B, Lq, H, KVH, S, window, bs, scale};
  return quant ? launch_t<int8_t>(a, D, s) : launch_t<__nv_bfloat16>(a, D, s);
}
