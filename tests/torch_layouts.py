"""Seeded point layouts shared by the port's proximity tests (numpy
only, so that the card's tests import them where JAX is not installed):
uniform, clustered, and seam-straddling bands, and the layout cases
that hold the cell-list search exactly, overflowed grids included."""
import numpy as np


def layout(kind, seed, n, area, n_lp=4):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pos = rng.uniform(0, area, (n, 2))
    elif kind == "clustered":  # three tight blobs: overflows the auto cap
        centers = np.array([[0.1, 0.1], [0.5, 0.9], [0.9, 0.4]]) * area
        pos = (centers[np.arange(n) % 3]
               + rng.standard_normal((n, 2)) * 0.015 * area) % area
    elif kind == "seam":  # band straddling the wrap line on both axes
        pos = (rng.uniform(0, area, (n, 2)) * 0.1 - area * 0.05) % area
    pos = pos.astype(np.float32)
    lp = rng.integers(0, n_lp, n).astype(np.int32)
    sender = rng.uniform(size=n) < 0.4
    return pos, lp, sender


CASES = [  # kind, seed, n, n_lp, area, rng, capacity
    ("uniform", 1, 200, 4, 1000.0, 80.0, 0),
    ("uniform", 2, 500, 3, 1000.0, 60.0, 0),
    ("uniform", 3, 96, 2, 100.0, 45.0, 0),  # area / rng < 3: no grid
    ("seam", 4, 150, 4, 300.0, 40.0, 150),
    ("seam", 5, 301, 8, 1000.0, 60.0, 301),
    ("clustered", 6, 240, 4, 1000.0, 100.0, 240),
    ("clustered", 7, 240, 4, 1000.0, 100.0, 0),  # overflowed: drop set
    ("uniform", 8, 400, 5, 1000.0, 100.0, 3),  # overflowed: tight cap
]
