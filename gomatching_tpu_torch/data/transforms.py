"""Training-time augmentation: EfficientDetResizeCrop (port of
``gomatching_tpu/data/transforms.py``).

Parity: gomatching/data/transforms/custom_augmentation_impl.py:27-66 +
custom_transform.py:29-92. A transform is a record of (scale, offsets), so one random
draw can be replayed on every frame of a clip, and interpolated between two draws for
still-image motion synthesis (vts_dataset_mapper.py:181-202). Images resize with PIL's
bilinear filter, as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from PIL import Image


@dataclass
class ResizeCropTransform:
    scaled_h: int
    scaled_w: int
    offset_y: int
    offset_x: int
    img_scale: float
    target_h: int
    target_w: int

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        pil = Image.fromarray(img).resize((self.scaled_w, self.scaled_h), Image.BILINEAR)
        ret = np.asarray(pil)
        right = min(self.scaled_w, self.offset_x + self.target_w)
        lower = min(self.scaled_h, self.offset_y + self.target_h)
        return ret[self.offset_y:lower, self.offset_x:right]

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        coords = coords.astype(np.float64).copy()
        coords[:, 0] = coords[:, 0] * self.img_scale - self.offset_x
        coords[:, 1] = coords[:, 1] * self.img_scale - self.offset_y
        return coords

    def apply_box(self, boxes_xyxy: np.ndarray) -> np.ndarray:
        b = self.apply_coords(boxes_xyxy.reshape(-1, 2)).reshape(-1, 2, 2)
        return np.concatenate([b.min(axis=1), b.max(axis=1)], axis=1)


def sample_resize_crop(image_hw, size: int, scale_range, rng: np.random.RandomState,
                       h: int = -1, w: int = -1) -> ResizeCropTransform:
    """Random-scale draw (EfficientDetResizeCrop.get_transform): a square ``size``
    target unless ``h``/``w`` name one."""
    target = (size, size) if (h < 0 and w < 0) else (h, w)
    sf = rng.uniform(*scale_range)
    ih, iw = image_hw
    img_scale = min(sf * target[0] / ih, sf * target[1] / iw)
    scaled_h, scaled_w = int(ih * img_scale), int(iw * img_scale)
    off_y = int(max(0.0, scaled_h - target[0]) * rng.uniform(0, 1))
    off_x = int(max(0.0, scaled_w - target[1]) * rng.uniform(0, 1))
    return ResizeCropTransform(scaled_h, scaled_w, off_y, off_x, img_scale, target[0], target[1])
