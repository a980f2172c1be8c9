"""COCO run-length-encoded mask codec (host numpy; no pycocotools dependency; the
port's copy of gomatching_tpu/evaluation/rle.py).

Implements the subset of ``pycocotools.mask`` semantics the ArTVideo protocol
touches (eval_trk.py:16 + :154 ``mask_utils.decode`` of per-annotation GT
segmentations): Fortran-order (column-major) RLE starting with a run of zeros,
in both the uncompressed form ({'size': [h, w], 'counts': [int, ...]}) and the
compressed LEB128-style string form pycocotools emits ({'counts': bytes/str}).
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def _counts_from_string(s: Union[bytes, str]) -> List[int]:
    """Decode pycocotools' compressed counts string (6-bit chunks biased by 48,
    with delta coding from the 3rd run on — maskApi.c rleFrString)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _counts_to_string(counts: List[int]) -> bytes:
    """Encode counts to pycocotools' compressed string (maskApi.c rleToString)."""
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            # maskApi.c rleToString: more = (c & 0x10) ? x != -1 : x != 0
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def decode(rle: Dict) -> np.ndarray:
    """RLE dict -> (h, w) uint8 mask. Accepts uncompressed (list counts) and
    compressed (bytes/str counts) forms, like ``pycocotools.mask.decode``."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _counts_from_string(counts)
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # column-major


def encode(mask: np.ndarray, compressed: bool = False) -> Dict:
    """(h, w) binary mask -> RLE dict (counts start with the zero run)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1)
    # run lengths
    changes = np.flatnonzero(np.diff(flat))
    starts = np.concatenate([[0], changes + 1])
    ends = np.concatenate([changes + 1, [flat.size]])
    runs = (ends - starts).tolist()
    counts = ([0] + runs) if flat.size and flat[0] == 1 else runs
    if not flat.size:
        counts = [0]
    if compressed:
        counts = _counts_to_string(counts)
    return {"size": [h, w], "counts": counts}
