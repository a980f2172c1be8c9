"""Character tables + CTC-style decoding of per-point recognition outputs.

Parity: gomatching/text_track_visualizer.py:37-55 (tables) and :167-182 (decode —
collapse consecutive repeats, reset on the unknown class).
"""

from __future__ import annotations

import pickle
from typing import List, Sequence

CTLABELS_37 = list("abcdefghijklmnopqrstuvwxyz0123456789")
CTLABELS_96 = [
    " ", "!", '"', "#", "$", "%", "&", "'", "(", ")", "*", "+", ",", "-", ".", "/",
    "0", "1", "2", "3", "4", "5", "6", "7", "8", "9", ":", ";", "<", "=", ">", "?",
    "@", "A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L", "M", "N", "O",
    "P", "Q", "R", "S", "T", "U", "V", "W", "X", "Y", "Z", "[", "\\", "]", "^", "_",
    "`", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m", "n", "o",
    "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z", "{", "|", "}", "~",
]


def load_char_table(voc_size: int, custom_dict: str = "") -> List:
    if voc_size == 37:
        return CTLABELS_37
    if voc_size == 96:
        return CTLABELS_96
    with open(custom_dict, "rb") as fp:
        table = pickle.load(fp)
    assert len(table) == voc_size - 1, f"dict size {len(table)} != voc_size-1 {voc_size - 1}"
    return table


def ctc_decode(rec: Sequence[int], voc_size: int, table: List) -> str:
    """Greedy decode: skip class >= voc_size-1 (unknown resets the repeat state),
    collapse consecutive repeats. Custom dicts store unicode codepoints."""
    last = None
    out = []
    for c in rec:
        c = int(c)
        if c < voc_size - 1:
            if last != c:
                out.append(table[c] if voc_size in (37, 96) else chr(table[c]))
                last = c
        else:
            last = None
    return "".join(out)
