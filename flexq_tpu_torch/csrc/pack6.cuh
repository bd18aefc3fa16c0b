// The 6-bit packed weight planes (flexq_tpu_torch/packing/pack6.py), as the
// CUDA kernels read them. A signed 6-bit weight w is stored biased,
// u = w + 32 in [0, 63], split as u = (hi << 2) | lo, in K-tiles of 128 rows,
// N-minor (row stride ldw bytes):
//
//   hi plane [K/2, ldw]: byte r (r < 64) of K-tile t holds the hi nibble of
//                        row t*128 + r (bits 0-3) and of row t*128 + r + 64
//                        (bits 4-7);
//   lo plane [K/4, ldw]: byte r (r < 32) of K-tile t holds the lo crumb of
//                        rows r, r + 32, r + 64, r + 96 in bit pairs
//                        0-1, 2-3, 4-5, 6-7.
//
// One K-tile is also one quant group (128 rows, one scale row).
#pragma once

#include <stdint.h>

namespace pack6 {

constexpr int KT = 128;  // pack K-tile == quant group
constexpr int BIAS = 32;

// Biased values of rows r and r + 64 of a K-tile (r in [0, 64)) from the hi
// byte of row r and the lo byte of row r % 32.
__device__ __forceinline__ void unpack_pair(uint32_t hi_byte, uint32_t lo_byte, int r,
                                            int& u_r, int& u_r64) {
  const int sh = 2 * (r >> 5);  // row r: crumb pair r / 32; row r + 64: pair r / 32 + 2
  u_r = (int)(((hi_byte & 0xFu) << 2) | ((lo_byte >> sh) & 3u));
  u_r64 = (int)((((hi_byte >> 4) & 0xFu) << 2) | ((lo_byte >> (sh + 4)) & 3u));
}

}  // namespace pack6
