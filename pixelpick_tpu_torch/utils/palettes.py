"""Colour palettes for visualisation (reference ``utils/utils.py:456-532``;
an own copy of ``pixelpick_tpu/utils/palettes.py``)."""

import numpy as np

PALETTE_CV = {
    0: (128, 128, 128), 1: (128, 0, 0), 2: (192, 192, 128), 3: (128, 64, 128),
    4: (0, 0, 192), 5: (128, 128, 0), 6: (192, 128, 128), 7: (64, 64, 128),
    8: (64, 0, 128), 9: (64, 64, 0), 10: (0, 128, 192), 11: (0, 0, 0),
}

PALETTE_CS = {
    0: (128, 64, 128), 1: (244, 35, 232), 2: (70, 70, 70), 3: (102, 102, 156),
    4: (190, 153, 153), 5: (153, 153, 153), 6: (250, 170, 30), 7: (220, 220, 0),
    8: (107, 142, 35), 9: (152, 251, 152), 10: (70, 130, 180), 11: (220, 20, 60),
    12: (255, 0, 0), 13: (0, 0, 142), 14: (0, 0, 70), 15: (0, 60, 100),
    16: (0, 80, 100), 17: (0, 0, 230), 18: (119, 11, 32), 19: (0, 0, 0),
}

PALETTE_VOC = {
    0: (0, 0, 0), 1: (128, 0, 0), 2: (0, 128, 0), 3: (128, 128, 0),
    4: (0, 0, 128), 5: (128, 0, 128), 6: (0, 128, 128), 7: (128, 128, 128),
    8: (64, 0, 0), 9: (192, 0, 0), 10: (64, 128, 0), 11: (192, 128, 0),
    12: (64, 0, 128), 13: (192, 0, 128), 14: (64, 128, 128), 15: (192, 128, 128),
    16: (0, 64, 0), 17: (128, 64, 0), 18: (0, 192, 0), 19: (128, 192, 0),
    20: (0, 64, 128), 255: (255, 255, 255),
}

CV_LABEL_CATEGORY = {
    0: "sky", 1: "building", 2: "pole", 3: "road", 4: "pavement", 5: "tree",
    6: "sign symbol", 7: "fence", 8: "car", 9: "pedestrian", 10: "bicyclist",
    11: "void",
}


def get_palette(dataset_name: str) -> dict:
    return {"cv": PALETTE_CV, "cs": PALETTE_CS, "voc": PALETTE_VOC}.get(
        dataset_name, PALETTE_CV)


def palette_lut(palette: dict) -> np.ndarray:
    """Dense 256x3 uint8 LUT — replaces the reference's per-pixel Python
    colouring loop (``utils/utils.py:403-407``) with one vectorised gather."""
    lut = np.zeros((256, 3), np.uint8)
    for k, v in palette.items():
        lut[k] = v
    return lut


def colorise_label(arr: np.ndarray, dataset: str = "cv") -> np.ndarray:
    assert arr.ndim == 2, arr.shape
    return palette_lut(get_palette(dataset))[np.clip(arr, 0, 255)]
