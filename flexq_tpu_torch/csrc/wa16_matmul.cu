// W6A16 and W4A16 GEMMs for Hopper (sm_90a), plain C interface: the 6- or
// 4-bit weights are dequantized to bf16 in the kernel and multiplied with
// bf16 activations on the tensor cores (wgmma), f32 accumulation.
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
//        The fused-plane variant passes the up planes as the gate planes
//        offset by nh columns, with the plane's row stride: nothing is copied.
//
// Numerics: the dequantized weight is bf16((u - BIAS) * ws), one f32 multiply
// rounded to nearest-even, as the TPU kernel rounds it; bf16 x bf16 products
// are exact in f32, so the kernel and its plain version (an f32 product of the
// same bf16 operands) differ only in the order of the f32 sums.
//
// Bound on this card: operations at prefill (M = 2048, K = N = 4096: 68.7
// GFLOP, 0.069 ms at 989 TFLOP/s; K8's 4096 -> 2 x 11264: 0.38 ms), bytes at
// weight-only decode (M = 4: the planes, 0.75 B a weight for W6, 0.5 B for
// W4, and their scales: 0.0039 ms for a 4096 x 4096 W6 matrix).
//
// Design: a block computes a 128 x 128 tile of weight columns (one 128-wide
// head for K7 / K11, so the RoPE partner column is in the block; for K8 64
// gate and the same 64 up columns), walking K in 128-deep steps (one pack
// K-tile = one quant group = one scale row):
// - two producer warps keep two rings of shared-memory stages full with TMA
//   (cp.async.bulk.tensor, completion on mbarriers): 3 stages of the x tile
//   (two 64-wide boxes in the 128-byte swizzle wgmma reads; TMA zero-fills
//   rows past M), and 2 stages of the raw plane tiles as they lie on disk
//   (hi rows [64, 128], lo rows [32, 128] or the W4 nibble rows: 2-D boxes
//   of the N-minor planes at the weight's column and row stride, so the
//   fused-plane K8 needs no copy) with the step's scale row. A plane stage
//   is free once dequantized, an x stage once its wgmmas are done, so both
//   run two steps ahead;
// - two consumer warpgroups dequantize a stage's planes into a bf16 weight
//   tile in shared memory (MN-major, 128-byte swizzle: a thread turns one
//   plane word, four columns of rows r and r + 64, into two 8-byte stores,
//   without bank conflicts, at offsets fixed per thread), then each runs
//   wgmma m64n128k16 (K8: m64n64k16 for gate and up) on its 64 rows of x (a
//   warpgroup whose rows all lie past M runs none). Three weight tiles
//   rotate and the wgmmas are asynchronous: a step's MMAs run on the tensor
//   cores while the warpgroups dequantize the next step, one barrier a
//   step, and each weight is dequantized once per 128 rows of x;
// - the epilogue stays in registers: a thread holds columns c and c ^ 64
//   of the same rows (RoPE), and gate and up of the same columns (K8);
// - small tile counts (decode, the scheduler's chunks) split K over blocks
//   so the launch fills the card: each split writes its f32 partial (the
//   rows below M) to scratch, and the last block of its tile to arrive
//   (an atomic counter, reset for the next call) adds them in split order
//   and runs the epilogue, so the call stays one launch;
// - tiles are walked in groups of 8 row tiles, so the blocks in flight
//   share their weight tiles and x rows in the L2.
// The geometry (tiles, splits, scratch size) is computed here alone: the
// wrapper asks flexq_wa16_matmul_sizes for the scratch it allocates.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "pack4.cuh"
#include "pack6.cuh"
#include "tma.cuh"  // mbarriers, TMA loads and maps, wgmma fences and descriptors

namespace {

using namespace hopper;

constexpr int BK = pack6::KT;   // K step: one pack K-tile, one quant group
constexpr int WT = 128;         // weight columns of a stage (NB weights of WT / NB columns)
constexpr int GROUP_M = 8;      // row tiles walked together
constexpr int MAX_SPLITS = 16;

struct Cfg {
  static constexpr int BM = 128;                 // rows of a tile: a warpgroup per 64
  static constexpr int SX = 3;                   // stages of the x ring
  static constexpr int SP = 2;                   // stages of the plane ring
  static constexpr int NBUF = 3;                 // bf16 weight tiles
  static constexpr int CT = 256;                 // consumer threads: two warpgroups
  static constexpr int THREADS = CT + 64;        // and two producer warps (x, planes)
  static constexpr int X_BYTES = BM * BK * 2;    // x tile: two [BM][64] bf16 halves
  static constexpr int B_BYTES = BK * WT * 2;    // the bf16 weight tile of a step
  static constexpr int HI_BYTES = 64 * WT, LO_BYTES = 32 * WT, SC_BYTES = WT * 4;
  static constexpr int OFF_B = SX * X_BYTES;     // offsets from the 1024-byte aligned base
  static constexpr int OFF_HI = OFF_B + NBUF * B_BYTES;
  static constexpr int OFF_LO = OFF_HI + SP * HI_BYTES;
  static constexpr int OFF_SC = OFF_LO + SP * LO_BYTES;
  static constexpr int OFF_BAR = OFF_SC + SP * SC_BYTES;  // x full / empty, plane full / empty, flag
  static constexpr int SMEM = OFF_BAR + 2 * (SX + SP) * 8 + 16 + 1024;  // + room to align the base
};

struct Params {
  const float* cosv;  // RoPE f32 [M, 128] (or null)
  const float* sin2;
  void* out;          // [M, N] bf16 or f32
  float* part;        // split partials
  int* counters;      // arrival counters, one per tile
  int M, N, K, out_bf16, act;
  int m_tiles, n_tiles, splits, sps;  // sps: K steps a split
};

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) * B (16 x 128, MN-major), bf16 in, f32 accumulators
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 16, K-major) * B (16 x 64, MN-major), bf16 in, f32 accumulators
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// bf16((u - bias) * s) of the four biased values in the bytes of u4 (one
// f32 multiply, rounded to nearest-even; (2^23 + u) - (2^23 + bias) is
// u - bias exactly), stored as four neighbouring columns at dst.
template <int BIAS>
__device__ __forceinline__ void store4(uint8_t* dst, uint32_t u4, const float4& s) {
  constexpr float MAGIC = 8388608.0f + (float)BIAS;
  const float sc[4] = {s.x, s.y, s.z, s.w};
  uint32_t packed[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 2 * h + e;
      const float f = __int_as_float((int)__byte_perm(u4, 0x4B000000u, 0x7440u + q)) - MAGIC;
      v[e] = __fmul_rn(f, sc[q]);
    }
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[0], v[1]);
    packed[h] = *reinterpret_cast<const uint32_t*>(&b2);
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
}

// A consumer thread's part of the dequant. A stage holds NB weights, each
// [64][WN] hi bytes, [32][WN] lo bytes and [WN] f32 scales as TMA laid them
// down; an item is one plane word (four columns) of hi row r, i.e. K rows r
// and r + 64. Thread ct always takes column word lw = ct % (WN / 4) and the
// rows r0 + RS j (r0 = ct / (WN / 4) < RS, RS a multiple of 8), so its
// offsets are fixed but for compile-time steps, and the swizzle of its
// stores ((chunk ^ (k % 8)) in the weight tile's 128-byte rows) is the same
// for all of them. A warp's 32 items read 32 neighbouring words.
template <int NB>
struct Dq {
  static constexpr int WN = WT / NB;        // columns of a weight
  static constexpr int RS = Cfg::CT / (WN / 4);  // rows between a thread's items
  static_assert(RS % 8 == 0 && 32 % RS == 0, "a thread's rows share their swizzle");
  int col;   // its first column (byte offset of its word in a plane row; 4 columns)
  int row0;  // r0 * WN + col: its first item's offset in a weight's hi / lo tile
  int b;     // its first item's byte offset in a weight's bf16 tile (MN-major, 64-column atoms of [BK][128 bytes])
  __device__ __forceinline__ explicit Dq(int ct) {
    const int lw = ct % (WN / 4), r0 = ct / (WN / 4);
    col = 4 * lw;
    row0 = r0 * WN + col;
    const int c = col & 63;
    b = (col >> 6) * (BK * 128) + r0 * 128 + ((((c >> 3) ^ (r0 & 7)) << 4) | ((c & 7) << 1));
  }
};

template <int NB, int FMT>
__device__ __forceinline__ void dequant(const uint8_t* hi, const uint8_t* lo, const float* sc, uint8_t* bt,
                                        const Dq<NB>& q) {
  constexpr int WN = Dq<NB>::WN, RS = Dq<NB>::RS;
#pragma unroll
  for (int w = 0; w < NB; ++w) {
    const float4 s = *reinterpret_cast<const float4*>(sc + w * WN + q.col);
#pragma unroll
    for (int j = 0; j < 64 / RS; ++j) {
      const int dr = RS * j;  // hi row r = r0 + dr; K rows r and r + 64
      const uint32_t h = *reinterpret_cast<const uint32_t*>(hi + w * 64 * WN + q.row0 + dr * WN);
      uint8_t* t = bt + w * (BK * WN * 2) + q.b + dr * 128;
      if constexpr (FMT == 6) {
        // rows r and r + 64 take the lo crumbs r / 32 and r / 32 + 2 of lo row r % 32
        const uint32_t l = *reinterpret_cast<const uint32_t*>(lo + w * 32 * WN + q.row0 + (dr & 31) * WN);
        const int sh = 2 * (dr >> 5);  // a compile-time constant: r0 < RS and RS divides 32
        store4<pack6::BIAS>(t, ((h & 0x0F0F0F0Fu) << 2) | ((l >> sh) & 0x03030303u), s);
        store4<pack6::BIAS>(t + 64 * 128, (((h >> 4) & 0x0F0F0F0Fu) << 2) | ((l >> (sh + 4)) & 0x03030303u), s);
      } else {
        store4<pack4::BIAS>(t, h & 0x0F0F0F0Fu, s);
        store4<pack4::BIAS>(t + 64 * 128, (h >> 4) & 0x0F0F0F0Fu, s);
      }
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

// RoPE's cos and sin2 of columns c, c + 1 of row m, through the read-only
// path (so the loads need not wait for the output stores before them)
__device__ __forceinline__ float4 rope_pair(const Params& p, int m, int c) {
  const float2 cs = __ldg(reinterpret_cast<const float2*>(p.cosv + (size_t)m * 128 + c));
  const float2 sn = __ldg(reinterpret_cast<const float2*>(p.sin2 + (size_t)m * 128 + c));
  return make_float4(cs.x, cs.y, sn.x, sn.y);
}

// The epilogue of one output pair: columns c, c + 1 (within the tile) of row m.
// t: the f32 sums of those columns; rot: of columns c ^ 64, c ^ 64 + 1, and
// cs: rope_pair(p, m, c) (RoPE); u: the up sums (K8).
template <int NB, bool ROPE>
__device__ __forceinline__ void emit(const Params& p, int m, int col, float2 t, float2 rot, float4 cs, float2 u) {
  if constexpr (ROPE) {
    const float2 sn = make_float2(cs.z, cs.w);
    t.x = __fadd_rn(__fmul_rn(t.x, cs.x), __fmul_rn(rot.x, sn.x));
    t.y = __fadd_rn(__fmul_rn(t.y, cs.y), __fmul_rn(rot.y, sn.y));
  }
  if constexpr (NB == 2) {
    t.x = __fmul_rn(act_f32(t.x, p.act), u.x);
    t.y = __fmul_rn(act_f32(t.y, p.act), u.y);
  }
  const size_t o = (size_t)m * p.N + col;
  if (p.out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(p.out) + o) = __floats2bfloat162_rn(t.x, t.y);
  else
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + o) = t;
}

// The consumer warpgroups of a block: dequantize each stage into the weight
// tile, run the wgmmas on it, and write the tile (or this split's partial,
// and the sum of all splits in the block that arrives last). A warpgroup
// whose 64 rows all lie past M (M <= 64) runs no MMA, only its share of the
// dequant.
template <int NB, bool ROPE, int FMT>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, uint64_t* bars, int m_tile, int n_tile,
                                        int split, int nsteps) {
  using C = Cfg;
  constexpr int BM = C::BM, SX = C::SX, SP = C::SP, CT = C::CT;
  uint64_t *xfull = bars, *xempty = bars + SX, *pfull = bars + 2 * SX, *pempty = bars + 2 * SX + SP;
  int* last_flag = reinterpret_cast<int*>(bars + 2 * (SX + SP));
  const int m0 = m_tile * BM, n0 = n_tile * (WT / NB);
  constexpr int WN = WT / NB, NACC = WN / 2;
  const int ct = threadIdx.x, wg = ct >> 7, lane = ct & 31, wq = (ct & 127) >> 5;
  const bool mma = m0 + 64 * wg < p.M;
  const Dq<NB> dq(ct);
  float acc[NB][NACC];
#pragma unroll
  for (int w = 0; w < NB; ++w)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[w][i] = 0.f;
  const uint32_t sx = smem_u32(smem), sb = smem_u32(smem + C::OFF_B);
  // step i's planes into weight tile buf; the plane stage is free afterwards
  auto stage_dequant = [&](int i, int buf) {
    const int slot = i % SP;
    mbar_wait(&pfull[slot], (i / SP) & 1);
    dequant<NB, FMT>(smem + C::OFF_HI + slot * C::HI_BYTES, smem + C::OFF_LO + slot * C::LO_BYTES,
                     reinterpret_cast<const float*>(smem + C::OFF_SC + slot * C::SC_BYTES),
                     smem + C::OFF_B + buf * C::B_BYTES, dq);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&pempty[slot]);
  };

  stage_dequant(0, 0);
  consumers_sync<CT>();
  for (int i = 0; i < nsteps; ++i) {
    const int slot = i % SX, buf = i % C::NBUF;
    mbar_wait(&xfull[slot], (i / SX) & 1);
    if (mma) {
      wgmma_fence();
#pragma unroll
      for (int w = 0; w < NB; ++w) fence_regs(acc[w]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // x: this warpgroup's 64 rows of the K half kk / 4, 16 columns in
        const uint64_t da =
            desc_sw128(sx + slot * C::X_BYTES + (kk >> 2) * (BM * 128) + wg * (64 * 128) + (kk & 3) * 32, 16, 1024);
#pragma unroll
        for (int w = 0; w < NB; ++w) {
          // weight: K rows 16 kk .. 16 kk + 15; 64-column atoms 16 KB apart
          const uint64_t db =
              desc_sw128(sb + buf * C::B_BYTES + w * (BK * WN * 2) + kk * (16 * 128), BK * 128, 1024);
          if constexpr (WN == 128)
            wgmma_n128(acc[w], da, db);
          else
            wgmma_n64(acc[w], da, db);
        }
      }
    }
    wgmma_commit();
    // the next step's weight tile, while this step's wgmmas run; its buffer
    // was last read by step i - 2, which every warpgroup has finished
    if (i + 1 < nsteps) stage_dequant(i + 1, (i + 1) % C::NBUF);
    wgmma_wait<1>();  // this warpgroup's step i - 1 is done: its x stage is free
#pragma unroll
    for (int w = 0; w < NB; ++w) fence_regs(acc[w]);
    if (i >= 1 && lane == 0) mbar_arrive(&xempty[(i - 1) % SX]);
    consumers_sync<CT>();  // tile i + 1 is written, and every warpgroup is done with step i - 1
  }
  wgmma_wait<0>();
#pragma unroll
  for (int w = 0; w < NB; ++w) fence_regs(acc[w]);

  // fragment: rows r and r + 8, columns 8 j + cq and + 1, at acc[4 j + {0, 1}] and acc[4 j + {2, 3}]
  const int rt = wg * 64 + wq * 16 + (lane >> 2);  // row within the tile
  const int cq = 2 * (lane & 3);
  const float2 zero = make_float2(0.f, 0.f);
  if (p.splits == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + rt + 8 * hr;
      if (m >= p.M) continue;
      float4 cs[WN / 8];  // the row's RoPE operands, all loads in flight at once
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) cs[j] = ROPE ? rope_pair(p, m, 8 * j + cq) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const float2 t = make_float2(acc[0][4 * j + 2 * hr], acc[0][4 * j + 2 * hr + 1]);
        float2 rot = zero, u = zero;
        if constexpr (ROPE) rot = make_float2(acc[0][4 * (j ^ 8) + 2 * hr], acc[0][4 * (j ^ 8) + 2 * hr + 1]);
        if constexpr (NB == 2) u = make_float2(acc[NB - 1][4 * j + 2 * hr], acc[NB - 1][4 * j + 2 * hr + 1]);
        emit<NB, ROPE>(p, m, n0 + 8 * j + cq, t, rot, cs[j], u);
      }
    }
    return;
  }

  // split K: this split's partial (rows below M; weight w at columns w WN ..)
  const int tile_id = m_tile * p.n_tiles + n_tile;
  float* tile_part = p.part + (size_t)tile_id * p.splits * BM * WT;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = rt + 8 * hr;
    if (m0 + r >= p.M) continue;
#pragma unroll
    for (int w = 0; w < NB; ++w)
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
        *reinterpret_cast<float2*>(tile_part + ((size_t)split * BM + r) * WT + w * WN + 8 * j + cq) =
            make_float2(acc[w][4 * j + 2 * hr], acc[w][4 * j + 2 * hr + 1]);
  }
  __threadfence();  // the partial is visible to the block that combines
  consumers_sync<CT>();
  if (ct == 0) {
    const int last = atomicAdd(p.counters + tile_id, 1) == p.splits - 1;
    if (last) p.counters[tile_id] = 0;  // ready for the next call
    *last_flag = last;
  }
  consumers_sync<CT>();
  if (!*last_flag) return;
  __threadfence();
  // the last block: the sums in split order, then the epilogue; four
  // columns a thread, four such groups in flight
  const int rows = min(BM, p.M - m0);
  auto sum4 = [&](int r, int c) {
    float4 v = __ldcg(reinterpret_cast<const float4*>(tile_part + (size_t)r * WT + c));
    for (int sp = 1; sp < p.splits; ++sp) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(tile_part + ((size_t)sp * BM + r) * WT + c));
      v = make_float4(__fadd_rn(v.x, a.x), __fadd_rn(v.y, a.y), __fadd_rn(v.z, a.z), __fadd_rn(v.w, a.w));
    }
    return v;
  };
  constexpr int G4 = WN / 4;  // four-column groups of a row
  for (int e0 = ct; e0 < rows * G4; e0 += 4 * CT) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * CT;
      if (e < rows * G4) {
        const int r = e / G4, c = 4 * (e % G4);
        const float4 t = sum4(r, c);
        float4 rot = make_float4(0.f, 0.f, 0.f, 0.f), u = rot;
        if constexpr (ROPE) rot = sum4(r, c ^ 64);
        if constexpr (NB == 2) u = sum4(r, WN + c);
        const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
        emit<NB, ROPE>(p, m0 + r, n0 + c, make_float2(t.x, t.y), make_float2(rot.x, rot.y),
                       ROPE ? rope_pair(p, m0 + r, c) : z4, make_float2(u.x, u.y));
        emit<NB, ROPE>(p, m0 + r, n0 + c + 2, make_float2(t.z, t.w), make_float2(rot.z, rot.w),
                       ROPE ? rope_pair(p, m0 + r, c + 2) : z4, make_float2(u.z, u.w));
      }
    }
  }
}

// NB = 1: K7 / K11 (ROPE optional); NB = 2: K8 (weight 0 = gate, weight 1
// = up). FMT: 6 (hi + lo planes) or 4 (the nibble plane in the hi maps).
template <int NB, bool ROPE, int FMT>
__global__ void __launch_bounds__(Cfg::THREADS, 1)
wa16_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap th0,
            const __grid_constant__ CUtensorMap tl0, const __grid_constant__ CUtensorMap ts0,
            const __grid_constant__ CUtensorMap th1, const __grid_constant__ CUtensorMap tl1,
            const __grid_constant__ CUtensorMap ts1, const Params p) {
  using C = Cfg;
  constexpr int BM = C::BM, SX = C::SX, SP = C::SP, CT = C::CT;
  constexpr int WN = WT / NB;  // columns of one weight in a tile (= output columns)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t *xfull = bars, *xempty = bars + SX, *pfull = bars + 2 * SX, *pempty = bars + 2 * SX + SP;

  // this block's tile (row tiles walked in groups of GROUP_M) and K split
  const int tile = blockIdx.x, split = blockIdx.y;
  const int per_group = GROUP_M * p.n_tiles;
  const int first_m = tile / per_group * GROUP_M;
  const int gm = min(p.m_tiles - first_m, GROUP_M);
  const int m_tile = first_m + (tile % per_group) % gm, n_tile = (tile % per_group) / gm;
  const int m0 = m_tile * BM, n0 = n_tile * WN;
  const int t0 = split * p.sps, nsteps = min(p.K / BK - t0, p.sps);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < SX; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], CT / 32);
    }
#pragma unroll
    for (int s = 0; s < SP; ++s) {
      mbar_init(&pfull[s], 1);
      mbar_init(&pempty[s], CT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == CT) {  // x producer: the step's two 64-wide K halves
    for (int i = 0; i < nsteps; ++i) {
      const int slot = i % SX, t = t0 + i;
      if (i >= SX) mbar_wait(&xempty[slot], ((i / SX) + 1) & 1);  // its last step's wgmmas are done
      mbar_expect_tx(&xfull[slot], BM * BK * 2);
      uint8_t* xs = smem + slot * C::X_BYTES;
      tma_load(xs, &tx, t * BK, m0, &xfull[slot]);
      tma_load(xs + BM * 128, &tx, t * BK + 64, m0, &xfull[slot]);
    }
  } else if (threadIdx.x == CT + 32) {  // plane producer: runs up to SP steps ahead of the dequant
    const CUtensorMap* hm[2] = {&th0, &th1};
    const CUtensorMap* lm[2] = {&tl0, &tl1};
    const CUtensorMap* sm[2] = {&ts0, &ts1};
    constexpr uint32_t TX = NB * (64 * WN + (FMT == 6 ? 32 * WN : 0) + WN * 4);
    for (int i = 0; i < nsteps; ++i) {
      const int slot = i % SP, t = t0 + i;
      if (i >= SP) mbar_wait(&pempty[slot], ((i / SP) + 1) & 1);  // its last step is dequantized
      mbar_expect_tx(&pfull[slot], TX);
#pragma unroll
      for (int w = 0; w < NB; ++w) {
        tma_load(smem + C::OFF_HI + slot * C::HI_BYTES + w * 64 * WN, hm[w], n0, t * 64, &pfull[slot]);
        if (FMT == 6)
          tma_load(smem + C::OFF_LO + slot * C::LO_BYTES + w * 32 * WN, lm[w], n0, t * 32, &pfull[slot]);
        tma_load(smem + C::OFF_SC + slot * C::SC_BYTES + w * WN * 4, sm[w], n0, t, &pfull[slot]);
      }
    }
  } else if (threadIdx.x < CT) {
    consume<NB, ROPE, FMT>(p, smem, bars, m_tile, n_tile, split, nsteps);
  }
}

// ---- host side ----------------------------------------------------------

// The launch's geometry, the one place it is computed: tiles of 128 rows and
// 128 / NB output columns. While the tiles alone leave SMs idle (fewer tiles
// than SMs), K is split into the fewest splits that fill the card as well as
// any up to MAX_SPLITS (waves of one block an SM, per split); a launch of as
// many tiles as SMs or more is never split,
// so its rows sum in the same order at every such M (a chunked prefill gives
// the whole prompt's bits).
struct Geometry {
  int m_tiles, n_tiles, splits, sps;
};

Geometry geometry(int M, int N, int K, int nb) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  Geometry g;
  g.m_tiles = (M + Cfg::BM - 1) / Cfg::BM;
  g.n_tiles = N / (WT / nb);
  const long long tiles = (long long)g.m_tiles * g.n_tiles;
  const int steps = K / BK;
  int best = 1;
  long long best_waves = (tiles + sms - 1) / sms;
  for (int s = 2; tiles < sms && s <= MAX_SPLITS && s <= steps; ++s) {
    const long long waves = (tiles * s + sms - 1) / sms;
    if (waves * best < best_waves * s) {  // waves / s < best_waves / best
      best = s;
      best_waves = waves;
    }
  }
  g.sps = (steps + best - 1) / best;
  g.splits = (steps + g.sps - 1) / g.sps;
  return g;
}

long long scratch_floats(const Geometry& g) {
  return g.splits > 1 ? (long long)g.m_tiles * g.n_tiles * g.splits * Cfg::BM * WT : 0;
}

struct Maps {
  CUtensorMap x, h[2], l[2], s[2];
};

template <int NB, bool ROPE, int FMT>
int launch(const Maps& m, const Params& p, cudaStream_t s) {
  auto kern = wa16_kernel<NB, ROPE, FMT>;
  constexpr int smem = Cfg::SMEM;
  static bool attr_set = false;  // once per instance: above 48 KB only after this
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(p.m_tiles * p.n_tiles, p.splits);
  kern<<<grid, Cfg::THREADS, smem, s>>>(m.x, m.h[0], m.l[0], m.s[0], m.h[1], m.l[1], m.s[1], p);
  return (int)cudaGetLastError();
}

int dispatch(const Maps& m, const Params& p, int glu, int fmt, bool rope, cudaStream_t s) {
  if (glu) return launch<2, false, 6>(m, p, s);
  if (fmt == 6) return rope ? launch<1, true, 6>(m, p, s) : launch<1, false, 6>(m, p, s);
  return rope ? launch<1, true, 4>(m, p, s) : launch<1, false, 4>(m, p, s);
}

bool bad_args(int M, int N, int K, int glu, int fmt) {
  return M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || N % WT != 0 || (fmt != 6 && fmt != 4) || (glu && fmt != 6);
}

}  // namespace

// fmt 6 (K7 / K8): weight j is hi [K/2, ldw] bytes, lo [K/4, ldw], ws f32
// [K/128, ldw]; fmt 4 (K11): the nibble plane [K/2, ldw] in hi, lo null.
// Pointers at the weight's first column (16-byte aligned; ldw % 16 == 0); x:
// bf16 [M, K] (16-byte aligned); out: [M, N] bf16 or f32. glu = 0: K7 / K11
// over weight 0, with RoPE when cos / sin2 (f32 [M, 128]) are not null;
// glu = 1 (fmt 6 only): K8, weight 0 = gate, weight 1 = up, act 0 = silu,
// 1 = gelu. part: f32 scratch of part_size floats and counters: int32, zero
// before the first call (each call leaves them zero), at least the sizes
// flexq_wa16_matmul_sizes gives. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it refuses.
extern "C" int flexq_wa16_matmul(const void* x, const void* hi0, const void* lo0, const void* ws0,
                                 const void* hi1, const void* lo1, const void* ws1, const void* cosv,
                                 const void* sin2, void* out, void* part, long long part_size, void* counters,
                                 int M, int N, int K, int ldw, int out_bf16, int glu, int act, int fmt,
                                 void* stream) {
  if (bad_args(M, N, K, glu, fmt) || ldw < N || ldw % 16 != 0 || (glu && act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  const bool rope = cosv != nullptr;
  if (glu && rope) return (int)cudaErrorInvalidValue;
  const int nb = glu ? 2 : 1;
  const Geometry g = geometry(M, N, K, nb);
  if (part_size < scratch_floats(g)) return (int)cudaErrorInvalidValue;
  const uint32_t wn = WT / nb, bm = Cfg::BM;
  Maps m;
  bool ok = make_map(&m.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, 64, bm,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  const void* his[2] = {hi0, glu ? hi1 : hi0};
  const void* los[2] = {fmt == 6 ? lo0 : hi0, glu ? lo1 : (fmt == 6 ? lo0 : hi0)};
  const void* wss[2] = {ws0, glu ? ws1 : ws0};
  for (int w = 0; w < 2; ++w) {
    ok = ok && make_map(&m.h[w], CU_TENSOR_MAP_DATA_TYPE_UINT8, his[w], N, K / 2, ldw, wn, 64,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
    ok = ok && make_map(&m.l[w], CU_TENSOR_MAP_DATA_TYPE_UINT8, los[w], N, fmt == 6 ? K / 4 : K / 2, ldw, wn,
                        32, CU_TENSOR_MAP_SWIZZLE_NONE);
    ok = ok && make_map(&m.s[w], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wss[w], N, K / BK, (uint64_t)ldw * 4, wn, 1,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const Params p{(const float*)cosv, (const float*)sin2, out, (float*)part, (int*)counters,
                 M, N, K, out_bf16, act, g.m_tiles, g.n_tiles, g.splits, g.sps};
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(m, p, glu, fmt, rope, s);
}

// The sizes a launch needs for these arguments: *part_floats floats of f32
// scratch (0 when K is not split) and *counters int32 arrival counters (one
// per tile). Returns 0, or cudaErrorInvalidValue for arguments that
// flexq_wa16_matmul refuses.
extern "C" int flexq_wa16_matmul_sizes(int M, int N, int K, int glu, int fmt, long long* part_floats,
                                       int* counters) {
  if (bad_args(M, N, K, glu, fmt)) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(M, N, K, glu ? 2 : 1);
  *part_floats = scratch_floats(g);
  *counters = g.m_tiles * g.n_tiles;
  return 0;
}
