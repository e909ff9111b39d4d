"""A seeded CT body phantom: Shepp-Logan-style ellipses in Hounsfield units.

Each slice is air around an elliptic body of fat and soft tissue, with two
lungs, a heart, an aorta, a vertebra and its canal. Every ellipse varies
smoothly with the slice index, so a series looks like consecutive axial
slices. The seed moves the ellipses (the phase and a small offset of each)
and draws the noise samples: the sizes, the tissue values and the noise
levels are fixed by the configuration, so every seed gives content of the
same statistics.
"""

from __future__ import annotations

import numpy as np

# (HU, centre x, centre y, half-axis x, half-axis y, angle in degrees), in
# units of half the frame's side; later ellipses paint over earlier ones.
BODY_ELLIPSES = (
    (-100.0, 0.00, 0.05, 0.86, 0.64, 0.0),    # subcutaneous fat
    (45.0, 0.00, 0.05, 0.78, 0.56, 0.0),      # muscle and soft tissue
    (-850.0, -0.38, -0.02, 0.25, 0.38, 8.0),  # right lung
    (-850.0, 0.38, -0.02, 0.23, 0.36, -8.0),  # left lung
    (40.0, 0.10, -0.05, 0.20, 0.17, -20.0),   # heart
    (55.0, -0.06, 0.22, 0.055, 0.055, 0.0),   # aorta
    (700.0, 0.00, 0.40, 0.11, 0.09, 0.0),     # vertebral body
    (20.0, 0.00, 0.52, 0.035, 0.03, 0.0),     # spinal canal
    (1000.0, 0.00, 0.40, 0.11, 0.09, 0.0),    # cortical rim (ring below)
)


def slice_phases(seed: int, client: int, n_ellipses: int) -> np.ndarray:
    """The phase and offsets of each ellipse for one client: [n, 3]."""
    rng = np.random.default_rng([int(seed), int(client), 1])
    return np.stack([rng.uniform(0.0, 2.0 * np.pi, n_ellipses),
                     rng.uniform(-1.0, 1.0, n_ellipses),
                     rng.uniform(-1.0, 1.0, n_ellipses)], axis=1)


def ct_slices(seed: int, client: int, count: int, params: dict) -> np.ndarray:
    """``count`` consecutive slices for ``client``, as stored samples:
    [count, rows, columns] uint16 of ``bits_stored`` bits.

    ``params`` holds rows, columns, bits_stored, rescale_intercept,
    air_hu, noise_body_hu, noise_air_hu, slice_period (slices a full cycle
    of the ellipses' variation), size_swing and shift (how far they vary,
    in units of half the side) and offset (how far the seed moves them).
    """
    rows, cols = int(params["rows"]), int(params["columns"])
    top = (1 << int(params["bits_stored"])) - 1
    intercept = float(params["rescale_intercept"])
    period = float(params["slice_period"])
    swing, shift = float(params["size_swing"]), float(params["shift"])
    offset = float(params["offset"])
    phases = slice_phases(seed, client, len(BODY_ELLIPSES))
    noise = np.random.default_rng([int(seed), int(client), 2])
    ys = ((np.arange(rows, dtype=np.float32) - (rows - 1) / 2.0)
          / (rows / 2.0))
    xs = ((np.arange(cols, dtype=np.float32) - (cols - 1) / 2.0)
          / (cols / 2.0))
    out = np.empty((count, rows, cols), dtype=np.uint16)
    for z in range(count):
        hu = np.full((rows, cols), float(params["air_hu"]), np.float32)
        body = np.zeros((rows, cols), dtype=bool)
        for k, (value, cx, cy, ax, ay, deg) in enumerate(BODY_ELLIPSES):
            phase, ox, oy = phases[k]
            wave = np.sin(2.0 * np.pi * z / period + phase)
            scale = 1.0 + swing * wave
            cx = cx + offset * ox + shift * wave * 0.5
            cy = cy + offset * oy
            t = np.deg2rad(deg)
            a, b = ax * scale, ay * scale
            # only the ellipse's bounding box is evaluated
            hx = np.hypot(a * np.cos(t), b * np.sin(t))
            hy = np.hypot(a * np.sin(t), b * np.cos(t))
            c0, c1 = np.searchsorted(xs, [cx - hx, cx + hx])
            r0, r1 = np.searchsorted(ys, [cy - hy, cy + hy])
            dx = xs[None, c0:c1] - cx
            dy = ys[r0:r1, None] - cy
            u = dx * np.cos(t) + dy * np.sin(t)
            v = -dx * np.sin(t) + dy * np.cos(t)
            r = (u / a) ** 2 + (v / b) ** 2
            if k == len(BODY_ELLIPSES) - 1:   # the vertebra's rim
                inside = (r <= 1.0) & (r > 0.7)
            else:
                inside = r <= 1.0
            hu[r0:r1, c0:c1][inside] = value
            if k == 0:
                body[r0:r1, c0:c1] = inside
        sigma = np.where(body, np.float32(params["noise_body_hu"]),
                         np.float32(params["noise_air_hu"]))
        hu += sigma * noise.standard_normal((rows, cols), dtype=np.float32)
        out[z] = np.clip(np.rint(hu - intercept), 0, top).astype(np.uint16)
    return out
