// The exact grouped integer GEMM for Hopper (sm_90a), plain C interface, in
// two routes from one source: int8 tensor cores (wgmma) for prompts, a
// streaming kernel for decode; the weight format (6, 4 or 8 bits) a template
// parameter of both.
//
// Replaces the TPU kernels
//   flexq_tpu/kernels/w6_matmul.py::w6_matmul        (_w6_matmul_kernel, K2)
//   flexq_tpu/kernels/w6_stream.py::w6_matmul_stream (_kernel, K3)
//   flexq_tpu/kernels/w4_matmul.py::w4_matmul        (_w4_matmul_kernel, K10)
//   flexq_tpu/kernels/w8_matmul.py::w8_matmul        (_w8_kernel, K12)
//
//   out[m, n] = sum over 128-groups g, in order g = 0, 1, ..., of
//               acc = acc + float(P[m,g,n]) * (xs[m,g] * ws[g,n])
//   P[m,g,n]  = sum_{k in g} xq[m,k] * w[k,n]
// with xq the 6- or 8-bit activation codes and w the signed weight as one of
//   FMT 6: u - 32, u in [0, 63] from pack6's hi and lo planes (pack6.cuh);
//   FMT 4: u - 8, u in [0, 15] from pack4's nibble plane (pack4.cuh: pack6's
//          hi layout with the nibble holding the value);
//   FMT 8: the int8 weight itself, a dense N-minor [K, N] plane.
// Only the planes a stage holds, its bytes (96, 64 or 128 rows of a group)
// and the unpack to s8 differ by format. P is an exact integer (|P| <
// 2^22, so its float is exact too) and the scale algebra uses __fmul_rn /
// __fadd_rn in the reference's order, so the result equals the plain
// PyTorch version (grouped_matmul_plain) bit for bit.
// No split of K ever adds f32 sums in another order: every output's terms
// reach one owner, which adds them in group order.
//
// Route A (tensor cores; prompts): operations bound at large M (M = 2048,
// K = N = 4096: 68.7 G int8 operations, 0.035 ms at 1979 TOPS). A block
// computes a 128-row x BN-column tile (BN = 128, or 64 when the 128-wide
// tiles leave SMs idle), one 128-deep group at a time:
// - TMA rings: 3 stages of the x codes (one [128 rows][128 bytes] box in the
//   128-byte swizzle, zero past M) and 3 of the raw plane tiles as stored
//   (W6: hi [64][BN], lo [32][BN]; W4: [64][BN]; W8: [128][BN]; and the
//   scale row), loaded by consumer thread 0 right after the group barrier
//   that frees a stage: with no producer warps the block is 256 threads,
//   whose registers (up to 255) hold the accumulators without spills (a
//   320-thread block was held to 168);
// - two consumer warpgroups build the group's K-major s8 weight tile
//   [BN][128] in the 128-byte swizzle wgmma reads (8-bit operands must be
//   K-major): a thread loads plane words (four columns of a row), unpacks
//   them to s8 four bytes at a time (W8's bytes are s8 already), turns four
//   K rows x four columns into four K-contiguous words with __byte_perm and
//   stores them; each thread's columns are rotated by its lane so the stores
//   spread over the banks;
// - each warpgroup runs wgmma m64nBNk32 s8.s8 -> s32 on its 64 rows (a
//   warpgroup whose rows all lie past M runs none), four per group, while
//   the next group's tile is built; then the epilogue adds the group's f32
//   terms to f32 accumulators in registers. The epilogue (a conversion, two
//   multiplies, an add per output and group) is the real limit: about
//   1.3 G CUDA-core operations at M = 2048, 4096^2;
// - three weight tiles rotate: one consumer barrier per group.
//
// Route B (streaming; decode): bytes bound (0.75 / 0.5 / 1 B a weight for
// W6 / W4 / W8, 4 B of scale per 128 weights: 12.6 MB for a 4096^2 W6
// matrix, 3.8 us at 3.35 TB/s). A block owns 128 output columns of all rows
// and streams a contiguous range of groups: each group is one ring stage
// (the group's plane rows as 128-byte row segments by TMA, its scale row
// and the x codes), 8 stages in flight per block. Each compute warp owns
// SB / nw stages and takes their groups: lane l unpacks columns 4l .. 4l + 3,
// transposes them with __byte_perm into words of four K rows and runs dp4a
// against the x words (rows in passes of RP; a biased format subtracts
// BIAS times the row's code sum), then writes the group's f32 terms. With
// one block a tile the terms go to a ring of slots in shared memory, and a
// fold warp adds them in group order. While the column tiles fill at most
// half the SMs (N = 4096), K is split over C blocks instead: every block
// writes its groups' terms to a scratch in global memory, and the last block
// of the tile to arrive (an arrival counter, left zero) adds all of them in
// group order. Thread block clusters, which would keep the terms on chip,
// were measured first: a cluster of 4 at this shared-memory size gets 30
// active clusters on 132 SMs, so a split into fours runs in two waves. W8's
// 128-row stages leave room for at most 32 rows (B_MAX_M).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "pack4.cuh"
#include "pack6.cuh"
#include "tma.cuh"

namespace {

using namespace hopper;

constexpr int KT = pack6::KT;  // 128: one quant group, one pack K-tile

// ---- shared pieces ------------------------------------------------------

// 4 x 4 byte transpose: byte j of out[c] is byte c of in[j]
__device__ __forceinline__ void transpose4(const uint32_t (&in)[4], uint32_t (&out)[4]) {
  const uint32_t a = __byte_perm(in[0], in[1], 0x5140), b = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t c = __byte_perm(in[2], in[3], 0x5140), d = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(a, c, 0x5410);
  out[1] = __byte_perm(a, c, 0x7632);
  out[2] = __byte_perm(b, d, 0x5410);
  out[3] = __byte_perm(b, d, 0x7632);
}

// The weight formats: plane rows of one group in a stage, and the bias of
// the stored value (W6 and W4 store u = w + BIAS, W8 stores w)
template <int FMT>
struct Fmt;
template <>
struct Fmt<6> {
  static constexpr int ROWS = 96, BIAS = pack6::BIAS;  // hi [64] + lo [32]
};
template <>
struct Fmt<4> {
  static constexpr int ROWS = 64, BIAS = pack4::BIAS;  // the nibble plane
};
template <>
struct Fmt<8> {
  static constexpr int ROWS = 128, BIAS = 0;  // the int8 weight
};

__host__ __device__ constexpr int plane_rows(int fmt) { return fmt == 6 ? 96 : fmt == 4 ? 64 : 128; }

// s8 bytes u - BIAS from biased bytes u in [0, 2 BIAS): (u + 0x80 - BIAS) ^ 0x80, no carry between bytes
template <int BIAS>
__device__ __forceinline__ uint32_t to_s8(uint32_t u4) {
  return (u4 + (0x80u - BIAS) * 0x01010101u) ^ 0x80808080u;
}

constexpr uint32_t NIBBLES = 0x0F0F0F0Fu;

// biased values of the four columns of a plane word: K row r (low nibble of
// hi byte r, crumb pair sh / 2 of lo byte r % 32) or K row r + 64 (high nibble)
__device__ __forceinline__ uint32_t u_low(uint32_t h, uint32_t l, int sh) {
  return ((h & 0x0F0F0F0Fu) << 2) | ((l >> sh) & 0x03030303u);
}
__device__ __forceinline__ uint32_t u_high(uint32_t h, uint32_t l, int sh) {
  return ((h >> 2) & 0x3C3C3C3Cu) | ((l >> (sh + 4)) & 0x03030303u);
}

__device__ __forceinline__ void store_out(void* out, size_t o, float v, int out_bf16) {
  if (out_bf16)
    reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(out)[o] = v;
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- route A: wgmma ------------------------------------------------------

// d (=|+)= A (64 x 32 s8, K-major) * B (32 x N s8, K-major), s32 accumulators
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <int FMT, int BN>
struct ACfg {
  static constexpr int BM = 128;               // rows of a tile: a consumer warpgroup per 64
  static constexpr int SX = 3, SP = 3;         // stages of the x ring and of the plane ring
  static constexpr int NBUF = 3;               // s8 weight tiles in rotation
  static constexpr int CT = 256;               // consumer threads: two warpgroups
  static constexpr int THREADS = CT;           // consumer thread 0 also issues the TMA loads
  static constexpr int QN = BN / 4;            // column quads (plane words) of a tile row
  static constexpr int RB = 64 * QN / CT;      // hi rows a thread unpacks (8 or 4)
  static constexpr int X_BYTES = BM * KT;      // x stage: [128 rows][128 bytes], swizzled
  static constexpr int B_BYTES = BN * KT;      // weight tile: [BN][128 bytes], swizzled
  static constexpr int PL_BYTES = Fmt<FMT>::ROWS * BN, SC_BYTES = BN * 4;  // a group's plane rows, scales
  static constexpr int OFF_B = SX * X_BYTES;   // offsets from the 1024-byte aligned base
  static constexpr int OFF_WS = OFF_B + NBUF * B_BYTES;  // each weight tile's scale row
  static constexpr int OFF_PL = OFF_WS + NBUF * SC_BYTES;
  static constexpr int OFF_SC = OFF_PL + SP * PL_BYTES;
  static constexpr int OFF_BAR = OFF_SC + SP * SC_BYTES;  // x full, plane full
  static constexpr int SMEM = OFF_BAR + (SX + SP) * 8 + 1024;  // + room to align the base
  static_assert(RB == 8 || RB == 4, "a thread unpacks 8 or 4 hi rows");
  static_assert(SMEM <= 227 * 1024, "route A's stages must fit the shared memory");
};

struct AParams {
  const float* xs;  // f32 [M, G]
  void* out;        // [M, N] bf16 or f32
  int M, N, K, out_bf16, m_tiles, n_tiles;
};

// Build group t's s8 weight tile from its plane stage. Thread ct takes
// column quad q = ct % QN and rows r0 .. r0 + RB - 1 (r0 = RB * (ct / QN)) of
// the group's first 64: K rows r0 .. and r0 + 64 .. (W6 / W4: the low and
// high nibbles of hi row r; W8: plane rows r and r + 64). Its four columns
// are rotated by rot = (q / 2) % 4 (byte s of a rotated plane word is column
// (s + rot) % 4), so a half warp's stores land in eight swizzle chunks.
template <int FMT, int BN>
struct Unpacker {
  using C = ACfg<FMT, BN>;
  int ld;       // byte offset of its first plane word in a hi / lo tile row
  int r0, sh;   // first hi row; crumb shift of its low-nibble rows
  int rot8;     // 8 * rot
  int off_lo[4], off_hi[4];  // tile byte offsets of column slot s at K rows r0 and r0 + 64

  __device__ __forceinline__ explicit Unpacker(int ct) {
    const int q = ct % C::QN;
    r0 = C::RB * (ct / C::QN);
    sh = 2 * (r0 >> 5);
    ld = 4 * q;
    const int rot = (q >> 1) & 3;
    rot8 = 8 * rot;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = 4 * q + ((s + rot) & 3);
      const int ck = r0 >> 4;  // 16-byte chunk of K row r0 (r0 + 64: chunk + 4)
      off_lo[s] = n * KT + (((ck ^ (n & 7)) << 4) | (r0 & 15));
      off_hi[s] = n * KT + ((((ck + 4) ^ (n & 7)) << 4) | (r0 & 15));
    }
  }

  // 4 K rows (r0 + 4 j4 ..) of the four columns as s8: words w_lo[s] (K
  // rows r0 + 4 j4 ..), w_hi[s] (+ 64), column slot s; pl: the plane stage
  __device__ __forceinline__ void rows4(const uint8_t* pl, int j4, uint32_t (&w_lo)[4], uint32_t (&w_hi)[4]) const {
    uint32_t a[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * j4 + j;
      uint32_t h = *reinterpret_cast<const uint32_t*>(pl + r * BN + ld);
      h = __funnelshift_r(h, h, rot8);
      if constexpr (FMT == 6) {  // lo rows follow the 64 hi rows
        uint32_t l = *reinterpret_cast<const uint32_t*>(pl + (64 + (r & 31)) * BN + ld);
        l = __funnelshift_r(l, l, rot8);
        a[j] = to_s8<Fmt<6>::BIAS>(u_low(h, l, sh));
        b[j] = to_s8<Fmt<6>::BIAS>(u_high(h, l, sh));
      } else if constexpr (FMT == 4) {
        a[j] = to_s8<Fmt<4>::BIAS>(h & NIBBLES);
        b[j] = to_s8<Fmt<4>::BIAS>((h >> 4) & NIBBLES);
      } else {  // W8: s8 already; K row r + 64 is plane row r + 64
        uint32_t h64 = *reinterpret_cast<const uint32_t*>(pl + (r + 64) * BN + ld);
        a[j] = h;
        b[j] = __funnelshift_r(h64, h64, rot8);
      }
    }
    transpose4(a, w_lo);
    transpose4(b, w_hi);
  }

  __device__ __forceinline__ void build(const uint8_t* pl, uint8_t* tile) const {
    if constexpr (C::RB == 8) {  // 8 K rows a column: 8-byte stores
      uint32_t l0[4], h0[4], l1[4], h1[4];
      rows4(pl, 0, l0, h0);
      rows4(pl, 1, l1, h1);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        *reinterpret_cast<uint2*>(tile + off_lo[s]) = make_uint2(l0[s], l1[s]);
        *reinterpret_cast<uint2*>(tile + off_hi[s]) = make_uint2(h0[s], h1[s]);
      }
    } else {
      uint32_t l0[4], h0[4];
      rows4(pl, 0, l0, h0);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        *reinterpret_cast<uint32_t*>(tile + off_lo[s]) = l0[s];
        *reinterpret_cast<uint32_t*>(tile + off_hi[s]) = h0[s];
      }
    }
  }
};

template <int FMT, int BN>
__device__ __forceinline__ void a_consume(const AParams& p, uint8_t* smem, uint64_t* bars, int m_tile, int n_tile,
                                          const CUtensorMap* tx, const CUtensorMap* th, const CUtensorMap* tl,
                                          const CUtensorMap* ts) {
  using C = ACfg<FMT, BN>;
  constexpr int SX = C::SX, SP = C::SP, CT = C::CT, NACC = BN / 2;
  uint64_t *xfull = bars, *pfull = bars + SX;
  const int G = p.K / KT;
  const int m0 = m_tile * C::BM, n0 = n_tile * BN;
  const int ct = threadIdx.x, wg = ct >> 7, lane = ct & 31, wq = (ct & 127) >> 5;
  const bool mma = m0 + 64 * wg < p.M;
  const Unpacker<FMT, BN> up(ct);
  // fragment: rows rt and rt + 8 of the tile, columns 8 j + cq and + 1
  const int rt = wg * 64 + wq * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int row0 = m0 + rt, row1 = row0 + 8;
  int acc_i[NACC];
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const uint32_t sx = smem_u32(smem), sb = smem_u32(smem + C::OFF_B);

  // group t's plane stage into weight tile buf (and its scale row beside
  // it); the plane stage is free afterwards
  auto build = [&](int t, int buf) {
    const int slot = t % SP;
    mbar_wait(&pfull[slot], (t / SP) & 1);
    up.build(smem + C::OFF_PL + slot * C::PL_BYTES, smem + C::OFF_B + buf * C::B_BYTES);
    if (ct < BN / 4)
      reinterpret_cast<float4*>(smem + C::OFF_WS + buf * C::SC_BYTES)[ct] =
          reinterpret_cast<const float4*>(smem + C::OFF_SC + slot * C::SC_BYTES)[ct];
    fence_proxy_async();
  };
  auto xs_of = [&](int row, int t) { return row < p.M ? __ldg(p.xs + (size_t)row * G + t) : 0.f; };
  // the TMA loads, issued by thread 0 once a stage is free: x stage t once
  // group t's wgmmas are done, plane stage t once tile t is built
  auto load_x = [&](int t) {
    const int slot = t % SX;
    mbar_expect_tx(&xfull[slot], C::X_BYTES);
    tma_load(smem + slot * C::X_BYTES, tx, t * KT, m0, &xfull[slot]);
  };
  auto load_planes = [&](int t) {
    const int slot = t % SP;
    uint8_t* pl = smem + C::OFF_PL + slot * C::PL_BYTES;
    mbar_expect_tx(&pfull[slot], C::PL_BYTES + C::SC_BYTES);
    if constexpr (FMT == 6) {
      tma_load(pl, th, n0, t * 64, &pfull[slot]);
      tma_load(pl + 64 * BN, tl, n0, t * 32, &pfull[slot]);
    } else {
      tma_load(pl, th, n0, t * Fmt<FMT>::ROWS, &pfull[slot]);
    }
    tma_load(smem + C::OFF_SC + slot * C::SC_BYTES, ts, n0, t, &pfull[slot]);
  };
  if (ct == 0) {
    for (int t = 0; t < SX && t < G; ++t) load_x(t);
    for (int t = 0; t < SP && t < G; ++t) load_planes(t);
  }

  build(0, 0);
  float xs0 = xs_of(row0, 0), xs1 = xs_of(row1, 0);
  consumers_sync<CT>();
  if (ct == 0 && SP < G) {  // plane stage 0 is free
    fence_proxy_async();
    load_planes(SP);
  }
  for (int t = 0; t < G; ++t) {
    const int slot = t % SX, buf = t % C::NBUF;
    mbar_wait(&xfull[slot], (t / SX) & 1);
    if (mma) {
      wgmma_fence();
      fence_regs(acc_i);
#pragma unroll
      for (int kk = 0; kk < KT / 32; ++kk) {
        // this warpgroup's 64 rows of x and the weight tile, 32 K in
        const uint64_t da = desc_sw128(sx + slot * C::X_BYTES + wg * (64 * KT) + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(sb + buf * C::B_BYTES + kk * 32, 16, 1024);
        if constexpr (BN == 128)
          wgmma_s8_n128(acc_i, da, db, kk);
        else
          wgmma_s8_n64(acc_i, da, db, kk);
      }
    }
    wgmma_commit();
    // the next group's weight tile while this group's wgmmas run; its
    // buffer was last read by group t - 2, which every warpgroup has finished
    if (t + 1 < G) build(t + 1, (t + 1) % C::NBUF);
    const float nxs0 = t + 1 < G ? xs_of(row0, t + 1) : 0.f, nxs1 = t + 1 < G ? xs_of(row1, t + 1) : 0.f;
    wgmma_wait<0>();
    fence_regs(acc_i);
    if (mma) {  // acc += float(P) * (xs * ws), in the reference's order
      const float* wsc = reinterpret_cast<const float*>(smem + C::OFF_WS + buf * C::SC_BYTES);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(wsc + 8 * j + cq);
        const float s00 = __fmul_rn(xs0, w.x), s01 = __fmul_rn(xs0, w.y);
        const float s10 = __fmul_rn(xs1, w.x), s11 = __fmul_rn(xs1, w.y);
        acc[4 * j] = __fadd_rn(acc[4 * j], __fmul_rn(__int2float_rn(acc_i[4 * j]), s00));
        acc[4 * j + 1] = __fadd_rn(acc[4 * j + 1], __fmul_rn(__int2float_rn(acc_i[4 * j + 1]), s01));
        acc[4 * j + 2] = __fadd_rn(acc[4 * j + 2], __fmul_rn(__int2float_rn(acc_i[4 * j + 2]), s10));
        acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3], __fmul_rn(__int2float_rn(acc_i[4 * j + 3]), s11));
      }
    }
    xs0 = nxs0;
    xs1 = nxs1;
    consumers_sync<CT>();  // tile t + 1 is written, and every warpgroup is done with tile t
    if (ct == 0) {  // x stage t and plane stage t + 1 are free now
      fence_proxy_async();
      if (t + SX < G) load_x(t + SX);
      if (t + 1 + SP < G) load_planes(t + 1 + SP);
    }
  }
  if (!mma) return;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + cq;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = hr ? row1 : row0;
      if (m >= p.M || n >= p.N) continue;  // N is even: n + 1 < N too
      const size_t o = (size_t)m * p.N + n;
      const float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
      if (p.out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(p.out) + o) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + o) = make_float2(v0, v1);
    }
  }
}

constexpr int GROUP_M = 8;  // row tiles walked together, so blocks in flight share weight tiles in the L2

template <int FMT, int BN>
__global__ void __launch_bounds__(ACfg<FMT, BN>::THREADS, 1)
w6ax_mma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap th,
                const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap ts, const AParams p) {
  using C = ACfg<FMT, BN>;
  constexpr int SX = C::SX, SP = C::SP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);

  const int tile = blockIdx.x;
  const int per_group = GROUP_M * p.n_tiles;
  const int first_m = tile / per_group * GROUP_M;
  const int gm = min(p.m_tiles - first_m, GROUP_M);
  const int m_tile = first_m + (tile % per_group) % gm, n_tile = (tile % per_group) / gm;

  if (threadIdx.x == 0) {  // x full, plane full: the expecting arrival and the TMA bytes
#pragma unroll
    for (int s = 0; s < SX + SP; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  a_consume<FMT, BN>(p, smem, bars, m_tile, n_tile, &tx, &th, &tl, &ts);
}

// ---- route B: streaming ---------------------------------------------------

constexpr int SBN = 128;       // columns of a block
constexpr int NW = 8;          // compute warps at most
constexpr int SB = 8;          // ring stages (one group each)
constexpr int B_THREADS = NW * 32 + 64;  // + the producer warp and the fold warp

// a group's plane rows and scale row in a ring stage (the x rows follow)
__host__ __device__ constexpr int plane_bytes(int fmt) { return plane_rows(fmt) * SBN + SBN * 4; }

// route B's rows at most: W8's 128-row stages leave room for 32
__host__ __device__ constexpr int b_max_m(int fmt) { return fmt == 8 ? 32 : 64; }

struct BParams {
  const float* xs;  // f32 [M, G]
  void* out;        // [M, N] bf16 or f32
  float* scratch;   // C > 1: every group's terms, [tiles][G][mp][SBN] f32
  int* counters;    // C > 1: arrival counters, one per column tile (left zero)
  int M, N, K, out_bf16;
  int mp;           // rows padded to the row pass (the x box's rows)
  int C, gps;       // blocks splitting K, groups a block
  int nw;           // compute warps (SB is a multiple: each owns SB / nw stages)
  int ts;           // C = 1: term slots in shared memory (a multiple of nw, or >= the groups)
  int stage, term;  // bytes of a ring stage, of a term slot
  int off_acc, off_terms, off_bar;
};

// One group's terms for rows m0 .. m0 + RP - 1 and lane l's columns 4l ..
// 4l + 3 (stage: the plane rows, the scale row, x rows), written to tsl (row
// pitch SBN floats: a term slot in shared memory, or the group's rows of the
// scratch).
template <int FMT, int RP>
__device__ __forceinline__ void b_group(const BParams& p, const uint8_t* st, float* tsl, int g, int m0, int lane) {
  constexpr int BIAS = Fmt<FMT>::BIAS;
  const uint32_t* pl = reinterpret_cast<const uint32_t*>(st);  // W6: hi rows, then lo rows at 64
  const float* sc = reinterpret_cast<const float*>(st + Fmt<FMT>::ROWS * SBN);
  const int* x = reinterpret_cast<const int*>(st + plane_bytes(FMT)) + m0 * (KT / 4);
  const int G = p.K / KT;
  float xsv[RP];
  int sx[RP], dot[RP][4];
#pragma unroll
  for (int m = 0; m < RP; ++m) {
    xsv[m] = m0 + m < p.M ? __ldg(p.xs + (size_t)(m0 + m) * G + g) : 0.f;
    sx[m] = 0;
    if constexpr (BIAS != 0) {  // the row's code sum, 4 K a lane
      int s = __dp4a(x[m * 32 + lane], 0x01010101, 0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
      sx[m] = s;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) dot[m][c] = 0;
  }
#pragma unroll 2
  for (int a = 0; a < 8; ++a) {
    uint32_t u[4][4];  // [i][c]: stored values of K rows 4a + 32 i .. 4a + 32 i + 3, column 4 lane + c
    if constexpr (FMT == 8) {  // plane rows are K rows
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = pl[(4 * a + 32 * i + j) * (SBN / 4) + lane];
        transpose4(w, u[i]);
      }
    } else {
      // hi rows 4a .., 4a + 32 .. (and W6's lo rows 4a ..): K rows 4a + 32 i ..
      uint32_t h0[4], h1[4], th0[4], th1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h0[j] = pl[(4 * a + j) * (SBN / 4) + lane];
        h1[j] = pl[(4 * a + 32 + j) * (SBN / 4) + lane];
      }
      transpose4(h0, th0);  // column c: hi bytes of K rows 4a .. 4a + 3 (low nibbles; high: + 64)
      transpose4(h1, th1);  // + 32
      if constexpr (FMT == 6) {
        uint32_t l[4], tl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) l[j] = pl[(64 + 4 * a + j) * (SBN / 4) + lane];
        transpose4(l, tl);  // crumb pair i: K rows 4a + 32 i ..
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          u[0][c] = u_low(th0[c], tl[c], 0);
          u[1][c] = u_low(th1[c], tl[c], 2);
          u[2][c] = u_high(th0[c], tl[c], 0);
          u[3][c] = u_high(th1[c], tl[c], 2);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          u[0][c] = th0[c] & NIBBLES;
          u[1][c] = th1[c] & NIBBLES;
          u[2][c] = (th0[c] >> 4) & NIBBLES;
          u[3][c] = (th1[c] >> 4) & NIBBLES;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < RP; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xw = x[m * 32 + a + 8 * i];  // the same word in every lane: a broadcast
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[m][c] = __dp4a(xw, (int)u[i][c], dot[m][c]);
      }
    }
  }
  const float4 w = reinterpret_cast<const float4*>(sc)[lane];
#pragma unroll
  for (int m = 0; m < RP; ++m) {
    if (m0 + m >= p.M) break;
    const int bias = BIAS * sx[m];
    float4 t;
    t.x = __fmul_rn(__int2float_rn(dot[m][0] - bias), __fmul_rn(xsv[m], w.x));
    t.y = __fmul_rn(__int2float_rn(dot[m][1] - bias), __fmul_rn(xsv[m], w.y));
    t.z = __fmul_rn(__int2float_rn(dot[m][2] - bias), __fmul_rn(xsv[m], w.z));
    t.w = __fmul_rn(__int2float_rn(dot[m][3] - bias), __fmul_rn(xsv[m], w.w));
    reinterpret_cast<float4*>(tsl + (m0 + m) * SBN)[lane] = t;
  }
}

// rows the fold warp keeps in registers (more rows fold in shared memory)
template <int RP>
__host__ __device__ constexpr int fold_rows() { return RP == 16 ? 16 : RP; }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ void store4(const BParams& p, int m, int n, float4 a) {
  const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (n + e < p.N) store_out(p.out, (size_t)m * p.N + n + e, v[e], p.out_bf16);
}

// C = 1: the fold warp adds each group's terms from the term slots in group
// order, up to fold_rows<RP>() rows in registers ...
template <int RP>
__device__ __forceinline__ void b_fold_regs(const BParams& p, const float* terms, uint64_t* tfull, uint64_t* tempty,
                                            int ng, int n0, int lane) {
  constexpr int FR = fold_rows<RP>();
  float4 acc[FR];
#pragma unroll
  for (int m = 0; m < FR; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < ng; ++i) {
    const int tsi = i % p.ts;
    mbar_wait(&tfull[tsi], (i / p.ts) & 1);
    const float4* t = reinterpret_cast<const float4*>(terms + (size_t)tsi * (p.term / 4)) + lane;
#pragma unroll
    for (int m = 0; m < FR; ++m)
      if (m < p.M) acc[m] = add4(acc[m], t[32 * m]);
    mbar_arrive(&tempty[tsi]);
  }
#pragma unroll
  for (int m = 0; m < FR; ++m)
    if (m < p.M) store4(p, m, n0 + 4 * lane, acc[m]);
}

// ... and any number of rows in shared memory (accbuf)
__device__ __forceinline__ void b_fold_smem(const BParams& p, const float* terms, float* accbuf, uint64_t* tfull,
                                            uint64_t* tempty, int ng, int n0, int lane) {
  float4* acc = reinterpret_cast<float4*>(accbuf) + lane;  // row m at acc[32 m]
  for (int m = 0; m < p.M; ++m) acc[32 * m] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < ng; ++i) {
    const int tsi = i % p.ts;
    mbar_wait(&tfull[tsi], (i / p.ts) & 1);
    const float4* t = reinterpret_cast<const float4*>(terms + (size_t)tsi * (p.term / 4)) + lane;
    for (int m = 0; m < p.M; ++m) acc[32 * m] = add4(acc[32 * m], t[32 * m]);
    mbar_arrive(&tempty[tsi]);
  }
  for (int m = 0; m < p.M; ++m) store4(p, m, n0 + 4 * lane, acc[32 * m]);
}

// C > 1: the last block of a column tile to arrive adds every group's terms
// from the scratch in group order; a thread takes two columns of a row, and
// keeps FB groups' loads in flight (the fold is bound by their latency)
__device__ __forceinline__ void b_fold_scratch(const BParams& p, int tile) {
  constexpr int FB = 32;
  const int G = p.K / KT;
  const float* base = p.scratch + (size_t)tile * G * p.mp * SBN;
  for (int u = threadIdx.x; u < p.M * (SBN / 2); u += blockDim.x) {
    const int m = u / (SBN / 2), c2 = 2 * (u % (SBN / 2));
    const float* col = base + (size_t)m * SBN + c2;
    float2 acc = make_float2(0.f, 0.f);
    for (int g0 = 0; g0 < G; g0 += FB) {
      float2 t[FB];
#pragma unroll
      for (int j = 0; j < FB; ++j)
        t[j] = g0 + j < G ? __ldcg(reinterpret_cast<const float2*>(col + (size_t)(g0 + j) * p.mp * SBN))
                          : make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < FB; ++j)
        if (g0 + j < G) acc = make_float2(__fadd_rn(acc.x, t[j].x), __fadd_rn(acc.y, t[j].y));
    }
    const int n = blockIdx.y * SBN + c2;
    if (n < p.N) store_out(p.out, (size_t)m * p.N + n, acc.x, p.out_bf16);
    if (n + 1 < p.N) store_out(p.out, (size_t)m * p.N + n + 1, acc.y, p.out_bf16);
  }
}

template <int FMT, int RP>
__global__ void __launch_bounds__(B_THREADS, 1)
w6ax_stream_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap th,
                   const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap ts, const BParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.off_bar);
  uint64_t *full = bars, *empty = bars + SB, *tfull = bars + 2 * SB, *tempty = tfull + p.ts;
  float* accbuf = reinterpret_cast<float*>(smem + p.off_acc);
  float* terms = reinterpret_cast<float*>(smem + p.off_terms);
  int* last_flag = reinterpret_cast<int*>(tempty + p.ts);  // C > 1: this block arrived last

  const int c = blockIdx.x, tile = blockIdx.y;  // groups c * gps .. of column tile `tile`
  const int n0 = tile * SBN;
  const int G = p.K / KT;
  const int g0 = c * p.gps, ng = min(p.gps, G - g0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int FR = fold_rows<RP>();

  if (threadIdx.x == 0) {
    for (int s = 0; s < SB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int s = 0; s < p.ts; ++s) {
      mbar_init(&tfull[s], 32);
      mbar_init(&tempty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW) {  // producer: runs up to SB groups ahead
    if (lane == 0) {
      for (int i = 0; i < ng; ++i) {
        const int slot = i % SB, g = g0 + i;
        if (i >= SB) mbar_wait(&empty[slot], ((i / SB) + 1) & 1);
        uint8_t* st = smem + slot * p.stage;
        mbar_expect_tx(&full[slot], p.stage);
        if constexpr (FMT == 6) {
          tma_load(st, &th, n0, g * 64, &full[slot]);
          tma_load(st + 64 * SBN, &tl, n0, g * 32, &full[slot]);
        } else {
          tma_load(st, &th, n0, g * Fmt<FMT>::ROWS, &full[slot]);
        }
        tma_load(st + Fmt<FMT>::ROWS * SBN, &ts, n0, g, &full[slot]);
        tma_load(st + plane_bytes(FMT), &tx, g * KT, 0, &full[slot]);
      }
    }
  } else if (warp < p.nw) {
    // compute: group i of the block in warp i % nw, always in ring stage i % SB
    // (a stage has one warp, so no barrier is waited on two phases apart)
    for (int i = warp; i < ng; i += p.nw) {
      const int slot = i % SB;
      mbar_wait(&full[slot], (i / SB) & 1);
      float* dst;
      const int tsi = p.C == 1 ? i % p.ts : 0;
      if (p.C == 1) {
        if (i >= p.ts) mbar_wait(&tempty[tsi], ((i / p.ts) + 1) & 1);  // the fold warp is done with the slot
        dst = terms + (size_t)tsi * (p.term / 4);
      } else {
        dst = p.scratch + ((size_t)tile * G + g0 + i) * p.mp * SBN;
      }
      for (int m0 = 0; m0 < p.M; m0 += RP) b_group<FMT, RP>(p, smem + slot * p.stage, dst, g0 + i, m0, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (p.C == 1) mbar_arrive(&tfull[tsi]);
    }
    if (p.C > 1) __threadfence();  // this warp's terms are visible before the block arrives
  } else if (warp == NW + 1 && p.C == 1) {  // fold: lane l owns columns 4l .. 4l + 3 of every row
    if (p.M <= FR)
      b_fold_regs<RP>(p, terms, tfull, tempty, ng, n0, lane);
    else
      b_fold_smem(p, terms, accbuf, tfull, tempty, ng, n0, lane);
  }
  if (p.C == 1) return;

  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(p.counters + tile, 1) == p.C - 1;
    if (last) p.counters[tile] = 0;  // ready for the next call
    *last_flag = last;
  }
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  b_fold_scratch(p, tile);
}

// ---- host side ----------------------------------------------------------

constexpr int SMEM_MAX = 227 * 1024;

int sm_count() {  // of the current device, asked once per device
  static int cached[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 132;
  if (cached[dev] == 0 && cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    cached[dev] = 132;
  return cached[dev];
}

// route B's rows a pass (4, 8 or 16)
int row_pass(int M) { return M <= 4 ? 4 : M <= 8 ? 8 : 16; }

template <typename F>
int set_smem(F kern, int bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int b_smem(const BParams& p) { return p.off_bar + (2 * SB + 2 * p.ts) * 8 + 16 + 1024; }

// Route B's geometry, the one place it is computed. While the 128-column
// tiles fill at most half the SMs (N = 4096), K is split over C blocks, C
// (up to 8) as many as fill the SMs once; C > 1 keeps every group's terms in
// the scratch, and the last block of a column tile to arrive folds them.
// C = 1 folds from term slots in shared memory (a slot for every group, or a
// multiple of the compute warps). Route B takes M <= b_max_m(fmt): its 8
// ring stages hold each group's plane rows and x rows.
BParams b_geometry(int fmt, int M, int N, int K) {
  BParams p{};
  const int rp = row_pass(M);
  p.M = M;
  p.N = N;
  p.K = K;
  p.mp = (M + rp - 1) / rp * rp;
  p.stage = plane_bytes(fmt) + p.mp * KT;
  p.term = p.mp * SBN * 4;
  const int G = K / KT, tiles = (N + SBN - 1) / SBN, sms = sm_count();
  const int ring = SB * p.stage;
  p.off_acc = ring;
  p.off_terms = p.off_acc + p.term;
  // C = 1: the term slots that fit, and the compute warps that leaves
  const int ts_max = (SMEM_MAX - ring - p.term - 4096) / p.term;
  p.nw = NW;
  while (p.nw > 1 && ts_max < p.nw && ts_max < G) p.nw /= 2;
  const bool one_fits = ts_max >= 1;
  p.ts = 0;
  p.off_bar = p.off_terms;  // C > 1 keeps no term slots
  // split K only while the column tiles fill at most half the SMs (or one
  // block's term slots do not fit), into as many blocks as fill the SMs once
  // (a block an SM: fewer, longer blocks measured faster than two an SM):
  // the split costs the terms' round trip through the scratch and the last
  // block's fold
  int best = 1;
  if (2 * tiles <= sms || !one_fits) best = std::min(std::min(8, G), std::max(2, sms / tiles));
  p.gps = (G + best - 1) / best;
  p.C = (G + p.gps - 1) / p.gps;  // no empty block
  if (p.C == 1) {
    p.ts = G <= ts_max ? G : ts_max / p.nw * p.nw;
    p.off_bar = p.off_terms + p.ts * p.term;
  } else {
    p.nw = NW;
  }
  return p;
}


long long b_scratch_floats(const BParams& p) {
  return p.C > 1 ? (long long)((p.N + SBN - 1) / SBN) * (p.K / KT) * p.mp * SBN : 0;
}

template <int FMT, int RP>
int launch_stream(const CUtensorMap (&maps)[4], const BParams& p, cudaStream_t s) {
  auto kern = w6ax_stream_kernel<FMT, RP>;
  const int smem = b_smem(p);
  if (smem > SMEM_MAX || (p.C == 1 && p.ts < 1)) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // once per instance: above 48 KB only after this
  if (!attr_set) {
    const int e = set_smem(kern, SMEM_MAX);
    if (e != 0) return e;
    attr_set = true;
  }
  kern<<<dim3(p.C, (p.N + SBN - 1) / SBN), B_THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

template <int FMT, int BN>
int launch_mma(const CUtensorMap (&maps)[4], const AParams& p, cudaStream_t s) {
  auto kern = w6ax_mma_kernel<FMT, BN>;
  constexpr int smem = ACfg<FMT, BN>::SMEM;
  static bool attr_set = false;  // once per instance: above 48 KB only after this
  if (!attr_set) {
    const int e = set_smem(kern, smem);
    if (e != 0) return e;
    attr_set = true;
  }
  kern<<<p.m_tiles * p.n_tiles, ACfg<FMT, BN>::THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// route A's column tile: 128, or 64 while the 128-wide tiles leave SMs idle
int a_tile_n(int M, int N) {
  const long long tiles128 = (long long)((M + 127) / 128) * ((N + 127) / 128);
  return tiles128 >= sm_count() ? 128 : 64;
}

bool bad_args(int fmt, int M, int N, int K, int route) {
  return (fmt != 6 && fmt != 4 && fmt != 8) || M <= 0 || N <= 0 || K <= 0 || K % KT != 0 || N % 16 != 0 ||
         (route != 0 && route != 1) || (route == 1 && M > b_max_m(fmt));
}

// The weight plane maps (box: bn columns, a group's rows): W6's hi and lo,
// W4's nibble plane or W8's bytes (maps[2] then repeats maps[1]); false for
// a base or stride TMA refuses.
bool plane_maps(int fmt, CUtensorMap* maps, const void* p0, const void* p1, int N, int K, int bn) {
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  const uint32_t rows = fmt == 6 ? 64 : plane_rows(fmt);  // a group's rows of p0
  if (!make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, p0, N, (uint64_t)K / KT * rows, N, bn, rows, none))
    return false;
  if (fmt != 6) {
    maps[1] = maps[0];
    return true;
  }
  return make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, p1, N, K / 4, N, bn, 32, none);
}

template <int FMT>
int run(const void* xq, const void* xs, const CUtensorMap (&pm)[2], const void* ws, void* out, void* scratch,
        long long scratch_floats, void* counters, int M, int N, int K, int out_bf16, int route, cudaStream_t s) {
  CUtensorMap maps[4];  // x, the plane maps, scales
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  maps[1] = pm[0];
  maps[2] = pm[1];
  if (route == 0) {
    const int bn = a_tile_n(M, N);
    bool ok = make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K, M, K, KT, 128, CU_TENSOR_MAP_SWIZZLE_128B);
    ok = ok && make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, N, K / KT, (uint64_t)N * 4, bn, 1, none);
    if (!ok) return (int)cudaErrorInvalidValue;
    AParams p{(const float*)xs, out, M, N, K, out_bf16, (M + 127) / 128, (N + bn - 1) / bn};
    return bn == 128 ? launch_mma<FMT, 128>(maps, p, s) : launch_mma<FMT, 64>(maps, p, s);
  }
  BParams p = b_geometry(FMT, M, N, K);
  if (scratch_floats < b_scratch_floats(p) || (p.C > 1 && counters == nullptr)) return (int)cudaErrorInvalidValue;
  p.xs = (const float*)xs;
  p.out = out;
  p.scratch = (float*)scratch;
  p.counters = (int*)counters;
  p.out_bf16 = out_bf16;
  bool ok = make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K, M, K, KT, p.mp, none);
  ok = ok && make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, N, K / KT, (uint64_t)N * 4, SBN, 1, none);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int rp = row_pass(M);
  if (rp == 4) return launch_stream<FMT, 4>(maps, p, s);
  if (rp == 8) return launch_stream<FMT, 8>(maps, p, s);
  return launch_stream<FMT, 16>(maps, p, s);
}

// every kernel instance: (name, function), for flexq_w6ax_kernel_attributes
struct Instance {
  const char* name;
  const void* fn;
};
const Instance INSTANCES[] = {
    {"mma<6,128>", (const void*)w6ax_mma_kernel<6, 128>},     {"mma<6,64>", (const void*)w6ax_mma_kernel<6, 64>},
    {"stream<6,4>", (const void*)w6ax_stream_kernel<6, 4>},   {"stream<6,8>", (const void*)w6ax_stream_kernel<6, 8>},
    {"stream<6,16>", (const void*)w6ax_stream_kernel<6, 16>}, {"mma<4,128>", (const void*)w6ax_mma_kernel<4, 128>},
    {"mma<4,64>", (const void*)w6ax_mma_kernel<4, 64>},       {"stream<4,4>", (const void*)w6ax_stream_kernel<4, 4>},
    {"stream<4,8>", (const void*)w6ax_stream_kernel<4, 8>},   {"stream<4,16>", (const void*)w6ax_stream_kernel<4, 16>},
    {"mma<8,128>", (const void*)w6ax_mma_kernel<8, 128>},     {"mma<8,64>", (const void*)w6ax_mma_kernel<8, 64>},
    {"stream<8,4>", (const void*)w6ax_stream_kernel<8, 4>},   {"stream<8,8>", (const void*)w6ax_stream_kernel<8, 8>},
    {"stream<8,16>", (const void*)w6ax_stream_kernel<8, 16>},
};

}  // namespace

// fmt 6: p0 = hi [K/2, N], p1 = lo [K/4, N] bytes (pack6); fmt 4: p0 = the
// nibble plane [K/2, N] (pack4); fmt 8: p0 = the int8 weight [K, N]; p1 is
// unused but for fmt 6. xq int8 [M, K] (16-byte aligned), xs f32 [M, K/128],
// ws f32 [K/128, N]; planes and scales 16-byte aligned with N % 16 == 0 (TMA
// reads them); out [M, N] bf16 or f32. route 0: tensor cores (any M);
// route 1: streaming (M <= 64, W8: <= 32), with scratch (f32,
// scratch_floats) and counters (int32, zero before the first call, left zero
// by every call) of at least the sizes flexq_w6ax_geometry gives. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it refuses.
extern "C" int flexq_w6ax_matmul(int fmt, const void* xq, const void* xs, const void* p0, const void* p1,
                                 const void* ws, void* out, void* scratch, long long scratch_floats, void* counters,
                                 int M, int N, int K, int out_bf16, int route, void* stream) {
  if (bad_args(fmt, M, N, K, route)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap pm[2];
  if (!plane_maps(fmt, pm, p0, p1, N, K, route == 0 ? a_tile_n(M, N) : SBN)) return (int)cudaErrorInvalidValue;
  if (fmt == 6) return run<6>(xq, xs, pm, ws, out, scratch, scratch_floats, counters, M, N, K, out_bf16, route, s);
  if (fmt == 4) return run<4>(xq, xs, pm, ws, out, scratch, scratch_floats, counters, M, N, K, out_bf16, route, s);
  return run<8>(xq, xs, pm, ws, out, scratch, scratch_floats, counters, M, N, K, out_bf16, route, s);
}

// The geometry a launch takes: info[0] = route A's column tile (route 0), or
// route B's blocks splitting K, groups a block, compute warps, term slots,
// shared-memory bytes (route 1); info[5] = the scratch floats and info[6]
// the arrival counters a call needs. Returns 0, or cudaErrorInvalidValue
// (also where route B's stages would not fit the shared memory).
extern "C" int flexq_w6ax_geometry(int fmt, int M, int N, int K, int route, long long* info) {
  if (bad_args(fmt, M, N, K, route)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 7; ++i) info[i] = 0;
  if (route == 0) {
    info[0] = a_tile_n(M, N);
    return 0;
  }
  const BParams p = b_geometry(fmt, M, N, K);
  if (b_smem(p) > SMEM_MAX || (p.C == 1 && p.ts < 1)) return (int)cudaErrorInvalidValue;
  info[0] = p.C;
  info[1] = p.gps;
  info[2] = p.nw;
  info[3] = p.ts;
  info[4] = b_smem(p);
  info[5] = b_scratch_floats(p);
  info[6] = p.C > 1 ? (N + SBN - 1) / SBN : 0;
  return 0;
}

// Kernel instance i's name (into name, at most len bytes with the NUL), its
// registers a thread and its local-memory bytes a thread (spills): 0, or 1
// past the last instance, or the CUDA error of cudaFuncGetAttributes.
extern "C" int flexq_w6ax_kernel_attributes(int i, char* name, int len, int* regs, int* local_bytes) {
  if (i < 0 || i >= (int)(sizeof(INSTANCES) / sizeof(INSTANCES[0]))) return 1;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, INSTANCES[i].fn);
  if (e != cudaSuccess) return (int)e;
  int n = 0;
  for (; INSTANCES[i].name[n] && n + 1 < len; ++n) name[n] = INSTANCES[i].name[n];
  name[n] = 0;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
