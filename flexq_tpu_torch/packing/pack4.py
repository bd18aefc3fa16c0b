"""4-bit weight packing (port of flexq_tpu/packing/pack4.py, same bytes).

A signed 4-bit value w in [-8, 7] is stored biased, u = w + 8 in [0, 15],
one nibble per value, packed along K in K-tiles of ``PACK_KT`` rows,
N-minor:

    plane: int8 [K/2, N] -- byte r of K-tile t holds u of rows (t*kt + r)
           in its low nibble and (t*kt + r + kt/2) in its high nibble.

This is the layout of pack6's hi plane with the nibble holding the whole
value. The GEMM undoes the bias exactly per 128-group: sum x*(u-8) =
sum x*u - 8*sum x.
"""

from __future__ import annotations

import torch

from flexq_tpu_torch.packing.pack6 import PACK_KT, _check_shape

BIAS4 = 8


def pack4(w_int: torch.Tensor, kt: int = PACK_KT) -> torch.Tensor:
    """Pack a signed-int4 matrix [K, N] into a nibble plane [K/2, N] int8."""
    k, n = w_int.shape
    _check_shape(k, kt)
    u_t = (w_int.to(torch.int32) + BIAS4).reshape(k // kt, kt, n)
    h = kt // 2
    packed = u_t[:, :h] | (u_t[:, h:] << 4)
    # int32 -> int8 wraps modulo 256, the same bytes as the reference's cast
    return packed.reshape(k // 2, n).to(torch.int8).contiguous()


def unpack4(plane: torch.Tensor, kt: int = PACK_KT) -> torch.Tensor:
    """Inverse of :func:`pack4`: signed int8 [K, N] in [-8, 7]."""
    k2, n = plane.shape
    k = k2 * 2
    _check_shape(k, kt)
    p_t = (plane.to(torch.int32) & 0xFF).reshape(k // kt, kt // 2, n)
    u = torch.cat([p_t & 0xF, (p_t >> 4) & 0xF], dim=1) - BIAS4
    return u.reshape(k, n).to(torch.int8)
