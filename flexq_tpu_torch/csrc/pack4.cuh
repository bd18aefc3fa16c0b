// The 4-bit packed weight plane (flexq_tpu_torch/packing/pack4.py), as the
// CUDA kernels read it. A signed 4-bit weight w is stored biased,
// u = w + 8 in [0, 15], in K-tiles of 128 rows, N-minor (row stride ldw
// bytes):
//
//   plane [K/2, ldw]: byte r (r < 64) of K-tile t holds u of row t*128 + r
//                     (bits 0-3) and of row t*128 + r + 64 (bits 4-7);
//
// the layout of pack6.cuh's hi plane with the nibble holding the whole value.
// One K-tile is also one quant group (128 rows, one scale row).
#pragma once

#include <stdint.h>

namespace pack4 {

constexpr int BIAS = 8;

// Biased values of rows r and r + 64 of a K-tile from the plane byte of row r.
__device__ __forceinline__ void unpack_pair(uint32_t byte, int& u_r, int& u_r64) {
  u_r = (int)(byte & 0xFu);
  u_r64 = (int)((byte >> 4) & 0xFu);
}

}  // namespace pack4
