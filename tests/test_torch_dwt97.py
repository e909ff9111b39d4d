"""Port parity: irreversible 9/7 DWT against the JAX package.

Small shapes are compared with the reference's op-by-op functions
(``fwd97_multilevel``/``inv97_multilevel``, ``go_dicom_codec_tpu/ops/
dwt97.py:120-139``), which run the same float32 ops in the same order:
tolerance 0, bit-identical. 61×37 is compared with the jitted wrappers
that the reference codec calls, where XLA's fusion moves results by float
rounding: |Δ| ≤ 0.005 on pixels of magnitude 2048 and their coefficients
(measured: ≤ 0.0025, 2-3 ulp at the coefficients' magnitude of 8000).
Those wrappers also fail to reconstruct a 1-sample-wide column at an odd
vertical origin over two or more levels, so small shapes never go through
them; ``test_port_round_trips`` covers that case for the port.

Each op-by-op reference call compiles its ops for a new shape, so the
shape × origin × level matrix is a covering, not a full product: shapes
from 1×1 to 9×9 on three diagonals of the grid, every origin parity and
every level 0-6 among them and on 61×37, both directions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from go_dicom_codec_tpu.ops import dwt97 as ref
from go_dicom_codec_torch.ops import dwt97 as port

# three diagonals of the 9×9 grid: every height and width 1-9 three
# times, squares, 1-wide and 1-tall shapes among them
SMALL_SHAPES = sorted({(h, w) for h in range(1, 10)
                       for w in (h, 10 - h, (4 * h) % 9 + 1)})
SMALL = [(shape, i % 2, (i // 2) % 2, i % 7)
         for i, shape in enumerate(SMALL_SHAPES)]
LARGE = [((61, 37), lv % 2, (lv // 2) % 2, lv) for lv in range(7)]


def _cases(rows):
    return [pytest.param(*c, id=f"{c[0][0]}x{c[0][1]}-o{c[1]}{c[2]}-l{c[3]}")
            for c in rows]


JIT_TOL = 0.005


@pytest.mark.parametrize("shape,x0,y0,levels", _cases(SMALL + LARGE))
def test_dwt97_matches_reference(shape, x0, y0, levels, rng):
    x = rng.uniform(-2048, 2048, (2,) + shape).astype(np.float32)
    jit = shape == (61, 37)
    pairs = (((ref.fwd97_multilevel_jit, ref.inv97_multilevel_jit) if jit
              else (ref.fwd97_multilevel, ref.inv97_multilevel)),
             (port.fwd97_multilevel, port.inv97_multilevel))
    for ref_fn, port_fn in zip(*pairs):
        # the inverse gets the reference forward's coefficients
        want = np.asarray(ref_fn(jnp.asarray(x), levels, x0=x0, y0=y0))
        got = port_fn(torch.as_tensor(x), levels, x0, y0)
        x = np.array(want)
        assert got.dtype == torch.float32
        if jit:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=JIT_TOL)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("x0,y0", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_port_round_trips(x0, y0, rng):
    """fwd then inv gives the input back within float32 noise, on every
    small shape, 1-wide and 1-tall ones included; the input is left
    untouched."""
    for h in range(1, 10):
        for w in range(1, 10):
            x = torch.as_tensor(rng.uniform(-2048, 2048, (2, h, w))
                                .astype(np.float32))
            keep = x.clone()
            c = port.fwd97_multilevel(x, 6, x0, y0)
            back = port.inv97_multilevel(c, 6, x0, y0)
            assert torch.equal(x, keep)
            assert float((back - x).abs().max()) < 0.01, (h, w)


def test_norm_tables_equal():
    for level in range(-1, 12):
        for orient in range(-1, 5):
            assert port.dwt97_norm(level, orient) == \
                ref.dwt97_norm(level, orient)
            assert port.dwt53_norm(level, orient) == \
                ref.dwt53_norm(level, orient)
    assert port.DWT97_NORMS == ref.DWT97_NORMS
    assert port.DWT53_NORMS == ref.DWT53_NORMS
    assert (port.ALPHA, port.BETA, port.GAMMA, port.DELTA, port.K,
            port.INV_K) == (ref.ALPHA, ref.BETA, ref.GAMMA, ref.DELTA,
                            ref.K, ref.INV_K)
