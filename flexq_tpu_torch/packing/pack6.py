"""6-bit weight packing (port of flexq_tpu/packing/pack6.py, same bytes).

A signed 6-bit value w in [-32, 31] is stored biased, u = w + 32 in [0, 63],
split as u = (hi << 2) | lo and packed along K in K-tiles of ``PACK_KT``
rows, N-minor:

    hi plane: int8 [K/2, N] -- byte r of K-tile t holds hi of rows
              (t*kt + r) in its low nibble and (t*kt + r + kt/2) in its high
              nibble.
    lo plane: int8 [K/4, N] -- byte r holds lo of rows r, r+kt/4, r+kt/2,
              r+3kt/4 in bit pairs 0-1, 2-3, 4-5, 6-7.

The GEMM undoes the bias exactly per 128-group: sum x*(u-32) =
sum x*u - 32*sum x.
"""

from __future__ import annotations

from typing import Tuple

import torch

PACK_KT = 128
BIAS = 32


def _check_shape(k: int, kt: int) -> None:
    if k % kt != 0:
        raise ValueError(f"K={k} must be a multiple of the pack K-tile {kt}")
    if kt % 4 != 0:
        raise ValueError(f"pack K-tile must be a multiple of 4, got {kt}")


def pack6(w_int: torch.Tensor, kt: int = PACK_KT) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a signed-int6 matrix [K, N] into (hi [K/2, N], lo [K/4, N]) int8."""
    k, n = w_int.shape
    _check_shape(k, kt)
    u = w_int.to(torch.int32) + BIAS
    hi_t = (u >> 2).reshape(k // kt, kt, n)
    lo_t = (u & 3).reshape(k // kt, kt, n)
    h, q = kt // 2, kt // 4
    hi_packed = hi_t[:, :h] | (hi_t[:, h:] << 4)
    lo_packed = (
        lo_t[:, :q]
        | (lo_t[:, q : 2 * q] << 2)
        | (lo_t[:, 2 * q : 3 * q] << 4)
        | (lo_t[:, 3 * q :] << 6)
    )
    # int32 -> int8 wraps modulo 256, the same bytes as the reference's cast
    return (
        hi_packed.reshape(k // 2, n).to(torch.int8).contiguous(),
        lo_packed.reshape(k // 4, n).to(torch.int8).contiguous(),
    )


def unpack6(hi: torch.Tensor, lo: torch.Tensor, kt: int = PACK_KT) -> torch.Tensor:
    """Inverse of :func:`pack6`: signed int8 [K, N] in [-32, 31]."""
    k2, n = hi.shape
    k = k2 * 2
    _check_shape(k, kt)
    h, q = kt // 2, kt // 4
    hi32 = hi.to(torch.int32) & 0xFF
    lo32 = lo.to(torch.int32) & 0xFF
    hi_t = hi32.reshape(k // kt, h, n)
    lo_t = lo32.reshape(k // kt, q, n)
    u_hi = torch.cat([(hi_t & 0xF) << 2, (hi_t >> 2) & 0x3C], dim=1)
    crumbs = torch.cat(
        [lo_t & 3, (lo_t >> 2) & 3, (lo_t >> 4) & 3, (lo_t >> 6) & 3], dim=1
    )
    return ((u_hi | crumbs) - BIAS).reshape(k, n).to(torch.int8)
