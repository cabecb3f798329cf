"""Dense bit-packing of fixed-width records for the device->host event fetch.

Layout (as in v2ce_toolbox_tpu/ops/bitpack.py): records are grouped 32 at
a time; group g's records occupy the 32*b-bit little-endian bitstream
word[k][g], k = 0..b-1, record i at bit offset b*i. n records take
ceil(n/32)*b words, and a kept-prefix fetch is the slice words[:, :G].
"""

from __future__ import annotations

import numpy as np
import torch


def pack_bits(recs: torch.Tensor, b: int) -> torch.Tensor:
    """Pack (n,) b-bit records (high bits ignored) into a (b, n//32) int32
    tensor holding the uint32 word bits (view it as uint32 on the host).
    n must be a multiple of 32. The shifts run in int64, since torch has
    few uint32 ops."""
    assert 1 <= b <= 32
    n = recs.shape[0]
    assert n % 32 == 0, n
    g = n // 32
    r = (recs.to(torch.int64) & ((1 << b) - 1)).view(g, 32).t()   # (32, G)
    rows = []
    for k in range(b):
        lo = 32 * k
        w = torch.zeros((g,), dtype=torch.int64, device=recs.device)
        for i in range(lo // b, min((lo + 31) // b, 31) + 1):
            off = b * i - lo
            w = w | (r[i] << off if off >= 0 else r[i] >> (-off))
        rows.append(w & 0xFFFFFFFF)
    words = torch.stack(rows)
    # two's-complement reinterpretation of the low 32 bits
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_bits(words: np.ndarray, b: int, n: int) -> np.ndarray:
    """Host-side inverse of pack_bits: (b, G) words -> (n,) uint32 records
    (n <= 32*G; trailing pad records are garbage the caller sliced away)."""
    assert 1 <= b <= 32
    w = np.ascontiguousarray(np.asarray(words)).view(np.uint32) \
        if np.asarray(words).dtype != np.uint32 else np.asarray(words)
    if n == 0:
        return np.zeros(0, np.uint32)
    r = np.arange(n, dtype=np.int64)
    g = r >> 5
    lob = b * (r & 31)
    k0 = lob >> 5
    sh = (lob & 31).astype(np.uint32)
    lo = w[k0, g] >> sh
    spans = (sh + b) > 32
    hi_shift = np.where(spans, 32 - sh, 0).astype(np.uint32)
    hi = np.where(spans, w[np.minimum(k0 + 1, b - 1), g] << hi_shift, 0)
    mask = np.uint32((1 << b) - 1) if b < 32 else np.uint32(0xFFFFFFFF)
    return ((lo | hi) & mask).astype(np.uint32)
