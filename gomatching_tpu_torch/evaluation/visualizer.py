"""Track visualization: per-track colored polygons + (id)text overlays (the port's
copy of gomatching_tpu/evaluation/visualizer.py; drawn pixels are identical).

Parity: ``TextTrackingVisualizer`` (gomatching/text_track_visualizer.py:19-266):
a stable per-track color pool, the boundary polygon of each instance, and an
"(id)transcription" label at the first boundary point. cv2-based (the reference
draws through matplotlib/d2's Visualizer; the rendered content is the same).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# matplotlib-tab20-like pool, RGB 0-255 (the reference samples random colors per
# track id from a fixed pool, text_track_visualizer.py:56-74)
_COLOR_POOL = np.asarray(
    [
        (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
        (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
        (188, 189, 34), (23, 190, 207), (174, 199, 232), (255, 187, 120),
        (152, 223, 138), (255, 152, 150), (197, 176, 213), (196, 156, 148),
        (247, 182, 210), (199, 199, 199), (219, 219, 141), (158, 218, 229),
    ],
    np.uint8,
)


def track_color(track_id: int) -> tuple:
    c = _COLOR_POOL[int(track_id) % len(_COLOR_POOL)]
    return int(c[0]), int(c[1]), int(c[2])


def boundary_to_closed_polygon(bd: np.ndarray) -> np.ndarray:
    """(npts, 4) top/bottom boundary points -> closed (2*npts, 2) polygon
    (top left->right then bottom right->left), like the reference's
    pre_vis_process (text_track_visualizer.py:76-91)."""
    bd = np.asarray(bd, np.float64).reshape(-1, 4)
    top = bd[:, :2]
    bottom = bd[::-1, 2:]
    return np.concatenate([top, bottom], axis=0)


# Unicode label font discovery: the reference draws Chinese transcriptions with
# a user-supplied ./simsun.ttc via matplotlib FontProperties
# (text_track_visualizer.py:236-251 draw_chinese); we look for the same file
# plus the usual system CJK fonts, overridable via $GOMATCHING_LABEL_FONT.
_FONT_CANDIDATES = (
    "./simsun.ttc",
    "/usr/share/fonts/opentype/noto/NotoSansCJK-Regular.ttc",
    "/usr/share/fonts/truetype/noto/NotoSansCJK-Regular.ttc",
    "/usr/share/fonts/truetype/wqy/wqy-zenhei.ttc",
    "/usr/share/fonts/truetype/droid/DroidSansFallbackFull.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",  # wide non-CJK Unicode
)
_FONT_CACHE: dict = {}


def find_label_font() -> Optional[str]:
    """First existing Unicode-capable label font, or None (Hershey fallback)."""
    import os

    cands = (os.environ.get("GOMATCHING_LABEL_FONT", ""),) + _FONT_CANDIDATES
    for path in cands:
        if path and os.path.exists(path):
            return path
    return None


def _pil_font(size: int):
    path = find_label_font()
    if path is None:
        return None
    key = (path, size)
    font = _FONT_CACHE.get(key)
    if font is None:
        try:
            from PIL import ImageFont

            font = ImageFont.truetype(path, size)
        except Exception:  # noqa: BLE001
            return None
        _FONT_CACHE[key] = font
    return font


def draw_tracked_frame(
    frame_bgr: np.ndarray,
    boundaries: Sequence[np.ndarray],  # each (npts, 4)
    track_ids: Sequence[int],
    texts: Optional[Sequence[str]] = None,
    thickness: int = 2,
) -> np.ndarray:
    """Returns a copy of the frame with polygons + labels drawn (BGR).

    Labels containing non-ASCII characters (BOVText's Chinese transcriptions)
    render through a PIL text pass with a real Unicode font when one is found
    (cv2's Hershey fonts have no CJK glyphs and draw '?' boxes); pure-ASCII
    labels keep the cv2 fast path."""
    import cv2

    out = frame_bgr.copy()
    labels = []  # (label, anchor xy, RGB color)
    for i, (bd, tid) in enumerate(zip(boundaries, track_ids)):
        poly = boundary_to_closed_polygon(bd).astype(np.int32)
        r, g, b = track_color(tid)
        color = (b, g, r)  # cv2 is BGR
        cv2.polylines(out, [poly.reshape(-1, 1, 2)], True, color, thickness)
        label = f"({int(tid)})"
        if texts is not None and i < len(texts):
            label += texts[i]
        x, y = int(poly[0, 0]), max(int(poly[0, 1]) - 4, 10)
        labels.append((label, (x, y), (r, g, b)))

    unicode_font = None
    if any(any(ord(c) > 127 for c in lab) for lab, _, _ in labels):
        unicode_font = _pil_font(14)
    if unicode_font is not None:
        from PIL import Image, ImageDraw

        pil = Image.fromarray(out[:, :, ::-1])  # PIL draws in RGB
        draw = ImageDraw.Draw(pil)
        for label, (x, y), rgb in labels:
            # PIL anchors at the glyph top; cv2 at the baseline — keep the
            # label above the polygon like the cv2 path does
            draw.text((x, max(y - 12, 0)), label, fill=rgb, font=unicode_font)
        out = np.asarray(pil)[:, :, ::-1].copy()
    else:
        for label, (x, y), rgb in labels:
            cv2.putText(out, label, (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        rgb[::-1], 1, cv2.LINE_AA)
    return out


def save_tracked_video_frames(
    frames_bgr: List[np.ndarray],
    tracked,  # list of FrameDetections (with .bd, .track_ids, optional texts)
    out_dir: str,
    decode_text=None,
):
    """Render every frame of a tracked video to ``out_dir/<n>.jpg``."""
    import os

    import cv2

    os.makedirs(out_dir, exist_ok=True)
    for n, (frame, det) in enumerate(zip(frames_bgr, tracked), start=1):
        texts = [decode_text(r) for r in det.recs] if decode_text is not None else None
        vis = draw_tracked_frame(frame, det.bd, det.track_ids, texts)
        cv2.imwrite(os.path.join(out_dir, f"{n}.jpg"), vis)
