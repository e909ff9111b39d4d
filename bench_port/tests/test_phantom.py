"""The phantom: the same seed gives the same frames; another seed moves
the ellipses and the noise but keeps the statistics."""

from __future__ import annotations

import numpy as np

from bench_port import phantom, spec

PARAMS = dict(spec.load_config("ct-j2k-lossless")["phantom"],
              rows=128, columns=128)


def test_deterministic_per_seed_and_client():
    a = phantom.ct_slices(2**31 + 5, 0, 3, PARAMS)
    b = phantom.ct_slices(2**31 + 5, 0, 3, PARAMS)
    assert a.dtype == np.uint16 and a.shape == (3, 128, 128)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, phantom.ct_slices(2**31 + 6, 0, 3, PARAMS))
    assert not np.array_equal(a, phantom.ct_slices(2**31 + 5, 1, 3, PARAMS))


def test_statistics_fixed_across_seeds():
    """Over one period of the slices' variation, which a client's corpus
    spans, the share of air, the mean and the peak hold across seeds."""
    air = 1024 + PARAMS["air_hu"]
    period = int(PARAMS["slice_period"])
    stats = []
    for seed in (1, 2**31 + 17, 2**32 + 3, 987654321):
        f = phantom.ct_slices(seed, 0, period, PARAMS).astype(np.float64)
        outside = np.abs(f - air) <= 10
        stats.append((outside.mean(), f.mean(), f.max()))
        assert f.max() < (1 << PARAMS["bits_stored"])
    shares, means, tops = zip(*stats)
    assert max(shares) - min(shares) < 0.01
    assert max(means) / min(means) < 1.01
    assert max(tops) - min(tops) < 200


def test_noise_levels_are_the_configured_ones():
    f = phantom.ct_slices(3, 0, 1, dict(PARAMS, rows=256, columns=256))[0]
    corner = f[:20, :20].astype(np.float64)
    assert abs(corner.std() - PARAMS["noise_air_hu"]) < 0.5
    tissue = f[np.abs(f.astype(np.int64) - 1069) < 50].astype(np.float64)
    assert tissue.size > 1000   # muscle, heart and aorta at 40-55 HU
    assert abs(tissue.std() - PARAMS["noise_body_hu"]) < 2.0


def test_slices_vary_smoothly():
    f = phantom.ct_slices(9, 0, 3, PARAMS).astype(np.int64)
    near = np.mean(np.abs(f[1] - f[0]) > 50)
    far = np.mean(np.abs(phantom.ct_slices(9, 0, 33, PARAMS)[32]
                         .astype(np.int64) - f[0]) > 50)
    assert near < far
