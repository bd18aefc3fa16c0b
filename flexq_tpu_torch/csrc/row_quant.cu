// The fused activation producers for Hopper (sm_90a), plain C interface: a
// row producer y, then the per-group quant of y in 128-wide groups,
//
//   scale = clamp(absmax(y) * (1 / qmax), 1e-5, 1e4)
//   q     = clamp(rint(y / scale), -qmax - 1, qmax)       (int8 codes)
//
// one kernel for five TPU kernels, the producer a template parameter MODE:
//   0 identity                           flexq_tpu/kernels/fused_quant.py::quant_act       (K4)
//   1 RMSNorm                            flexq_tpu/kernels/fused_quant.py::rmsnorm_quant   (K1)
//   2 residual add, then RMSNorm         flexq_tpu/kernels/fused_quant.py::rmsnorm_quant   (K1)
//   3 act(gate) * up, silu or tanh-gelu  flexq_tpu/kernels/fused_quant.py::glu_quant       (K5)
//   4 LayerNorm                          flexq_tpu/kernels/fused_quant.py::layernorm_quant (K14)
//   5 residual add, then LayerNorm       flexq_tpu/kernels/fused_quant.py::layernorm_quant (K14)
//   6 ReLU                               flexq_tpu/kernels/fused_quant.py::relu_quant      (K15)
// The residual modes also write x + r in the model dtype.
//
// Bound on this card: bytes (each row read once, written once as int8 plus
// a scale per 128 values; a few operations a byte). At decode (M = 4) the
// data is 32-88 KB and the time is the launch and one load's latency, so
// the design spreads a row's groups over as many warps as it can and keeps
// the host path short (one ctypes call, no per-call compilation):
// - a warp owns 128-groups: lane l holds values 4l .. 4l + 3 of a group (one
//   8-byte load for bf16, 16 bytes for f32), the group's absmax takes 5
//   shuffles, the codes go out as one 4-byte store a lane and lane 0 stores
//   the scale. No shared memory.
// - modes with no row statistic (0, 3, 6) spread (row, group) pairs over
//   the whole grid, four warps a block: at M = 4 every group has its own
//   warp (K5's 352 groups run on 88 blocks); once the groups fill the card
//   several times (M = 2048) a warp takes GPS consecutive groups and loads
//   them all before it quantizes any, so enough bytes are in flight to
//   stream.
// - modes with a row statistic (RMS: the mean square; LayerNorm: the mean,
//   then the variance of the centred row) keep the row in registers, one
//   block a row (GPW groups a warp, a template parameter), between the
//   statistic and the quant. Where a warp holds at most 2 groups (decode)
//   gamma and beta are loaded while the sums are taken, so the quant waits
//   on no second load; with more (M = 2048) they are loaded after the sums,
//   from the L2 that the first rows filled, and the registers they would
//   hold go to more rows in flight. The sums (row_sum) take one order
//   whatever the block's shape, so a row's bits do not depend on M.
//
// Rounding as the reference's compiled kernels: IEEE division for y / scale
// (__fdiv_rn) and rintf (half to even); a multiply by the f32 reciprocal
// where the reference divides by a constant (qmax, K); no FMA contraction
// (every product and sum an __fmul_rn / __fadd_rn); expf and tanhf without
// fast math (the functions PyTorch's CUDA ops call); RMSNorm's cast to the
// model dtype before the gamma multiply; LayerNorm's y * gamma + beta in
// f32; 1 / sqrt rounded twice, as PyTorch's CPU rsqrt (rsqrtf parts from it
// by an ulp on a third of the rows). The RMS and LayerNorm sums run in
// another order than the plain version's, so a row's statistic may part
// from it by an ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { IDENT = 0, RMS = 1, RMS_RES = 2, GLU = 3, LN = 4, LN_RES = 5, RELU = 6 };

constexpr int GS = 128;          // quant group
constexpr int MAXG = 8;          // groups a warp holds (statistic modes)
constexpr int STREAM_WARPS = 4;  // warps a block (modes without a statistic)
constexpr int GPS = 4;           // groups a warp, once they fill the card (modes without a statistic)
constexpr int MAX_WARPS = 16;    // warps a block (statistic modes)
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

__host__ __device__ constexpr bool has_stat(int mode) { return mode == RMS || mode == RMS_RES || mode == LN || mode == LN_RES; }

struct Params {
  const void* x;  // [M, K] model dtype: x, gate
  const void* r;  // [M, K] model dtype: the residual, up
  const void* g;  // [K] gamma (bf16 or f32)
  const void* b;  // [K] beta (bf16 or f32)
  int8_t* q;      // [M, K] codes
  float* s;       // [M, K/128] scales
  void* ro;       // [M, K] model dtype: x + r
  int M, K, G;
  int act;             // GLU: 0 silu, 1 tanh-gelu
  int g_bf16, b_bf16;  // gamma's, beta's dtype
  float eps, qmax, rq, rk;  // rq = f32(1 / qmax), rk = f32(1 / K)
  int gps;             // modes without a statistic: groups a warp (1 or GPS)
};

struct V4 {
  float v[4];
};

template <bool BF16>
__device__ __forceinline__ V4 load4(const void* base, size_t i) {
  V4 o;
  if constexpr (BF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(base) + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    o.v[0] = a.x, o.v[1] = a.y, o.v[2] = b.x, o.v[3] = b.y;
  } else {
    const float4 w = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(base) + i);
    o.v[0] = w.x, o.v[1] = w.y, o.v[2] = w.z, o.v[3] = w.w;
  }
  return o;
}

__device__ __forceinline__ V4 load4_any(const void* base, size_t i, int bf16) {
  return bf16 ? load4<true>(base, i) : load4<false>(base, i);
}

template <bool BF16>
__device__ __forceinline__ void store4(void* base, size_t i, const V4& o) {
  if constexpr (BF16) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(o.v[0], o.v[1]), b = __floats2bfloat162_rn(o.v[2], o.v[3]);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&a);
    w.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(base) + i) = w;
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(base) + i) = make_float4(o.v[0], o.v[1], o.v[2], o.v[3]);
  }
}

// y of the modes without a row statistic, in the reference's operation order
template <int MODE>
__device__ __forceinline__ float produce(float x, float u, int act) {
  if constexpr (MODE == RELU) {
    return fmaxf(x, 0.f);
  } else if constexpr (MODE == GLU) {
    if (act == 0) {  // x * sigmoid(x) * u, sigmoid = 1 / (1 + exp(-x))
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
      return __fmul_rn(__fmul_rn(x, sig), u);
    }
    // x * 0.5 * (1 + tanh(c * (x + 0.044715 * x^3))) * u
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float t = tanhf(__fmul_rn(GELU_C, __fadd_rn(x, __fmul_rn(0.044715f, x3))));
    const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, t));
    return __fmul_rn(__fmul_rn(x, cdf), u);
  } else {
    return x;
  }
}

// Quantize one group: the warp holds y (lane l: values 4l .. 4l + 3) of
// pair t = row * G + group (its codes start at t * 128, its scale at t).
__device__ __forceinline__ void quant_group(const Params& p, size_t t, int lane, const V4& y) {
  float a = fmaxf(fmaxf(fabsf(y.v[0]), fabsf(y.v[1])), fmaxf(fabsf(y.v[2]), fabsf(y.v[3])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xFFFFFFFFu, a, o));
  const float scale = fminf(fmaxf(__fmul_rn(a, p.rq), 1e-5f), 1e4f);
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(y.v[e], scale)), -p.qmax - 1.f), p.qmax);
    w |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(c) << (8 * e);
  }
  *reinterpret_cast<uint32_t*>(p.q + t * GS + 4 * lane) = w;
  if (lane == 0) p.s[t] = scale;
}

// ---- modes without a row statistic: p.gps (row, group) pairs a warp -----

// Pair t of the M x G pairs is row t / G, group t % G, and its values start
// at t * 128: a warp's pairs are one contiguous stretch of memory.
template <int MODE, bool BF16>
__global__ void __launch_bounds__(STREAM_WARPS * 32) row_quant_groups(const Params p) {
  const long long pairs = (long long)p.M * p.G;
  const long long t0 = ((long long)blockIdx.x * STREAM_WARPS + (threadIdx.x >> 5)) * p.gps;
  if (t0 >= pairs) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  V4 x[GPS], u[GPS];
#pragma unroll
  for (int j = 0; j < GPS; ++j) {  // every load first
    if (j < p.gps && t0 + j < pairs) {
      x[j] = load4<BF16>(p.x, (size_t)(t0 + j) * GS + 4 * lane);
      if constexpr (MODE == GLU) u[j] = load4<BF16>(p.r, (size_t)(t0 + j) * GS + 4 * lane);
    }
  }
#pragma unroll
  for (int j = 0; j < GPS; ++j) {
    if (j < p.gps && t0 + j < pairs) {
      V4 y;
#pragma unroll
      for (int e = 0; e < 4; ++e) y.v[e] = produce<MODE>(x[j].v[e], MODE == GLU ? u[j].v[e] : 0.f, p.act);
      quant_group(p, (size_t)(t0 + j), lane, y);
    }
  }
}

// ---- modes with a row statistic: a row a block ---------------------------

// The row's sum of v (slot i of warp w holds group i nw + w, lane l its
// values 4l .. 4l + 3) in one order whatever the block's shape: each group
// summed lane by lane (4 values in order, then a butterfly of shuffles), the
// group sums through shared memory (part: one a group), then lane l adds
// groups l, l + 32, ... in order and a butterfly adds the lanes. Every
// thread returns the same sum, and a row's bits do not depend on M. The
// order is not the CPU reduction's: a row's statistic may part from the
// plain version's by an ulp (the producers' tolerance).
template <int GPW>
__device__ __forceinline__ float row_sum(const V4 (&v)[GPW], int G, float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    if (i * nw + warp < G) {  // the same for the whole warp
      float a = __fadd_rn(__fadd_rn(__fadd_rn(v[i].v[0], v[i].v[1]), v[i].v[2]), v[i].v[3]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a = __fadd_rn(a, __shfl_xor_sync(0xFFFFFFFFu, a, o));
      if (lane == 0) part[i * nw + warp] = a;
    }
  }
  __syncthreads();
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_WARPS * MAXG / 32; ++j)
    if (lane + 32 * j < G) a = __fadd_rn(a, part[lane + 32 * j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = __fadd_rn(a, __shfl_xor_sync(0xFFFFFFFFu, a, o));
  return a;
}

template <int MODE, bool BF16, int GPW>
__global__ void __launch_bounds__(MAX_WARPS * 32, GPW <= 4 ? 2 : 1) row_quant_stat(const Params p) {
  __shared__ float part[2][MAX_WARPS * MAXG];  // a buffer a sum, so no warp overwrites what another still reads
  const size_t row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  constexpr bool RES = MODE == RMS_RES || MODE == LN_RES;
  constexpr bool IS_LN = MODE == LN || MODE == LN_RES;
  constexpr bool EARLY = GPW <= 2;  // gamma and beta loaded with the row (else after the sums)

  V4 h[GPW], gm[GPW], bt[GPW];
  {
    V4 r[GPW];
#pragma unroll
    for (int i = 0; i < GPW; ++i) {  // the row's loads first (and the residual's; EARLY: gamma's and beta's)
      const int grp = i * nw + warp;
      if (grp < p.G) {
        h[i] = load4<BF16>(p.x, row * p.K + (size_t)grp * GS + 4 * lane);
        if constexpr (RES) r[i] = load4<BF16>(p.r, row * p.K + (size_t)grp * GS + 4 * lane);
        if constexpr (EARLY) {
          gm[i] = load4_any(p.g, (size_t)grp * GS + 4 * lane, p.g_bf16);
          if constexpr (IS_LN) bt[i] = load4_any(p.b, (size_t)grp * GS + 4 * lane, p.b_bf16);
        }
      }
    }
    if constexpr (RES) {
#pragma unroll
      for (int i = 0; i < GPW; ++i) {
        const int grp = i * nw + warp;
        if (grp < p.G) {
#pragma unroll
          for (int e = 0; e < 4; ++e) h[i].v[e] = __fadd_rn(h[i].v[e], r[i].v[e]);
          store4<BF16>(p.ro, row * p.K + (size_t)grp * GS + 4 * lane, h[i]);
        }
      }
    }
  }
  V4 t[GPW];  // the summed values: LayerNorm's row, RMS's squares
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    if (i * nw + warp < p.G) {
#pragma unroll
      for (int e = 0; e < 4; ++e) t[i].v[e] = IS_LN ? h[i].v[e] : __fmul_rn(h[i].v[e], h[i].v[e]);
    }
  }
  float var = __fmul_rn(row_sum<GPW>(t, p.G, part[0]), p.rk);
  if constexpr (IS_LN) {  // var above is the mean; now the variance of the centred row
    const float mu = var;
#pragma unroll
    for (int i = 0; i < GPW; ++i) {
      if (i * nw + warp < p.G) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[i].v[e] = __fadd_rn(h[i].v[e], -mu);
          t[i].v[e] = __fmul_rn(h[i].v[e], h[i].v[e]);
        }
      }
    }
    var = __fmul_rn(row_sum<GPW>(t, p.G, part[1]), p.rk);
  }
  // 1 / sqrt(var + eps) as PyTorch's CPU rsqrt computes it (a rounded square
  // root, then a rounded division; rsqrtf parts from it by an ulp on about a
  // third of the rows, and LayerNorm's f32 y carries that into its scales)
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps)));
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    const int grp = i * nw + warp;
    if (grp < p.G) {
      if constexpr (!EARLY) {
        gm[i] = load4_any(p.g, (size_t)grp * GS + 4 * lane, p.g_bf16);
        if constexpr (IS_LN) bt[i] = load4_any(p.b, (size_t)grp * GS + 4 * lane, p.b_bf16);
      }
      V4 y;
      if constexpr (IS_LN) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y.v[e] = __fadd_rn(__fmul_rn(__fmul_rn(h[i].v[e], inv), gm[i].v[e]), bt[i].v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float u = __fmul_rn(h[i].v[e], inv);
          if constexpr (BF16) u = __bfloat162float(__float2bfloat16_rn(u));  // the model dtype first
          y.v[e] = __fmul_rn(u, gm[i].v[e]);
        }
      }
      quant_group(p, row * p.G + grp, lane, y);
    }
  }
}

// A launch floor: the same host path and launch with no work.
__global__ void empty_kernel() {}

// ---- host side ----------------------------------------------------------

int sm_count() {  // of the current device, asked once per device
  static int cached[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 132;
  if (cached[dev] == 0 && cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    cached[dev] = 132;
  return cached[dev];
}

// The statistic modes' geometry: warps a block (a row) and groups a warp
// (1, 2, 4 or 8), measured with scripts/torch_row_quant_parts.py geometry:
// DECODE_WARPS warps while the rows leave the card idle, FILL_WARPS once
// they fill it 4 times (M = 2048), the registers of fewer warps going to
// more rows in flight. False for a row wider than one block holds.
constexpr int DECODE_WARPS = 16;
constexpr int FILL_WARPS = 8;

bool stat_geometry(int M, int G, int* warps, int* gpw) {
  if (G > MAX_WARPS * MAXG) return false;
  const int want = M >= 4 * sm_count() ? FILL_WARPS : DECODE_WARPS;
  const int g = (G + want - 1) / want;
  *gpw = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
  *warps = (G + *gpw - 1) / *gpw;
  return true;
}

template <int MODE, bool BF16>
int launch_mode(Params p, cudaStream_t s) {
  if constexpr (!has_stat(MODE)) {
    const long long pairs = (long long)p.M * p.G;
    // a warp a pair while the pairs fill the card fewer than twice (64 warps an SM)
    p.gps = pairs >= 2LL * 64 * sm_count() ? GPS : 1;
    const long long warps = (pairs + p.gps - 1) / p.gps, blocks = (warps + STREAM_WARPS - 1) / STREAM_WARPS;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    row_quant_groups<MODE, BF16><<<(unsigned)blocks, STREAM_WARPS * 32, 0, s>>>(p);
  } else {
    int warps = 0, gpw = 0;
    if (!stat_geometry(p.M, p.G, &warps, &gpw)) return (int)cudaErrorInvalidValue;
    switch (gpw) {
      case 1: row_quant_stat<MODE, BF16, 1><<<(unsigned)p.M, warps * 32, 0, s>>>(p); break;
      case 2: row_quant_stat<MODE, BF16, 2><<<(unsigned)p.M, warps * 32, 0, s>>>(p); break;
      case 4: row_quant_stat<MODE, BF16, 4><<<(unsigned)p.M, warps * 32, 0, s>>>(p); break;
      default: row_quant_stat<MODE, BF16, 8><<<(unsigned)p.M, warps * 32, 0, s>>>(p); break;
    }
  }
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_dtype(int mode, const Params& p, cudaStream_t s) {
  switch (mode) {
    case IDENT: return launch_mode<IDENT, BF16>(p, s);
    case RMS: return launch_mode<RMS, BF16>(p, s);
    case RMS_RES: return launch_mode<RMS_RES, BF16>(p, s);
    case GLU: return launch_mode<GLU, BF16>(p, s);
    case LN: return launch_mode<LN, BF16>(p, s);
    case LN_RES: return launch_mode<LN_RES, BF16>(p, s);
    case RELU: return launch_mode<RELU, BF16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

struct Instance {
  const char* name;
  const void* fn;
};
#define STAT_INSTANCES(MODE, BF, TAG)                                                       \
  {"stat<" #MODE "," TAG ",1>", (const void*)row_quant_stat<MODE, BF, 1>},                  \
      {"stat<" #MODE "," TAG ",2>", (const void*)row_quant_stat<MODE, BF, 2>},              \
      {"stat<" #MODE "," TAG ",4>", (const void*)row_quant_stat<MODE, BF, 4>},              \
      {"stat<" #MODE "," TAG ",8>", (const void*)row_quant_stat<MODE, BF, 8>}
#define ROW_QUANT_INSTANCES(BF, TAG)                                                                          \
  {"groups<0," TAG ">", (const void*)row_quant_groups<IDENT, BF>}, STAT_INSTANCES(1, BF, TAG),               \
      STAT_INSTANCES(2, BF, TAG), {"groups<3," TAG ">", (const void*)row_quant_groups<GLU, BF>},              \
      STAT_INSTANCES(4, BF, TAG), STAT_INSTANCES(5, BF, TAG),                                                 \
      {"groups<6," TAG ">", (const void*)row_quant_groups<RELU, BF>}
const Instance INSTANCES[] = {ROW_QUANT_INSTANCES(true, "bf16"), ROW_QUANT_INSTANCES(false, "f32")};
#undef ROW_QUANT_INSTANCES
#undef STAT_INSTANCES

}  // namespace

// x (and r: the residual or up) [M, K] in the model dtype (x_bf16: bf16,
// else f32), gamma / beta [K] (g_bf16 / b_bf16), 16-byte aligned bases, K a
// multiple of 128 (the statistic modes: at most MAX_WARPS * MAXG groups);
// q int8 [M, K], s f32 [M, K/128], ro [M, K] model dtype (residual modes).
// act: 0 silu, 1 tanh-gelu (mode 3); rq = f32(1 / qmax), rk = f32(1 / K).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it refuses.
extern "C" int flexq_row_quant(int mode, int act, const void* x, const void* r, const void* g, const void* b, void* q,
                               void* s, void* ro, int M, int K, int x_bf16, int g_bf16, int b_bf16, float eps,
                               int qmax, float rq, float rk, void* stream) {
  if (M <= 0 || K <= 0 || K % GS != 0 || mode < 0 || mode > RELU) return (int)cudaErrorInvalidValue;
  Params p{x, r, g, b, (int8_t*)q, (float*)s, ro, M, K, K / GS, act, g_bf16, b_bf16, eps, (float)qmax, rq, rk, 1};
  cudaStream_t st = (cudaStream_t)stream;
  return x_bf16 ? launch_dtype<true>(mode, p, st) : launch_dtype<false>(mode, p, st);
}

// The empty kernel, launched as the producers are (the launch floor).
extern "C" int flexq_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Kernel instance i's name (into name, at most len bytes with the NUL), its
// registers a thread and its local-memory bytes a thread (spills): 0, or 1
// past the last instance, or the CUDA error of cudaFuncGetAttributes.
extern "C" int flexq_row_quant_kernel_attributes(int i, char* name, int len, int* regs, int* local_bytes) {
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
