"""Port parity: ``tools/fuzz.py`` against the reference tool, on the CPU.

``build_corpus`` must write the reference campaign's streams byte for byte
(read from the reference's ``main`` by recording what it hands
``_corrupt``), on the "device" engine (the plain torch lanes of the
kernels) and the "host" engine. ``_corrupt`` must draw the reference's
bytes for the same seed in modes 0-2, over 200 seeds; in mode 3 it must
equal the reference wherever the reference's flips change the stream, and
change every stream, including the ~3 % the reference leaves as they were
(a 0xFF within 8 bytes of the end). A short campaign on the CPU exits 0,
a single-trial replay exits 0, and no family exits 2, as the reference's
tests/test_fuzz_tool.py has it. Tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_dicom_codec_tpu.tools import fuzz as ref_fuzz
from go_dicom_codec_torch.tools import fuzz

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref_corpus():
    """The reference campaign's corpus, as its ``main`` builds it."""
    seen = []

    def record(rng, base, others, mode):
        seen.append(list(others))
        return base

    orig = ref_fuzz._corrupt
    ref_fuzz._corrupt = record
    try:
        assert ref_fuzz.main(["--trials", "1"]) == 0
    finally:
        ref_fuzz._corrupt = orig
    return seen[0]


@pytest.fixture(scope="module")
def corpus():
    return fuzz.build_corpus(fuzz.FAMILIES, CPU, "host")


@pytest.mark.parametrize("engine", ("device", "host"))
def test_corpus_matches_reference(ref_corpus, engine):
    got = fuzz.build_corpus(fuzz.FAMILIES, CPU, engine)
    assert [s for _, s in got] == ref_corpus
    assert [f for f, _ in got] == (["j2k"] * 15 + ["jpeg"] * 6
                                   + ["jls"] * 5 + ["rle"])


@pytest.mark.parametrize("mode", (0, 1, 2))
def test_modes_0_to_2_draw_reference_bytes(corpus, mode):
    blobs = [s for _, s in corpus]
    for seed in range(200):
        base = blobs[seed % len(blobs)]
        a, b = (np.random.default_rng(77000 + seed) for _ in range(2))
        assert fuzz._corrupt(a, base, blobs, mode) == \
            ref_fuzz._corrupt(b, base, blobs, mode), seed
        assert a.integers(1 << 30) == b.integers(1 << 30)


def test_mode_3_always_mutates(corpus):
    blobs = [s for _, s in corpus]
    ref_noops = 0
    for seed in range(200):
        for base in blobs:
            got = fuzz._corrupt(np.random.default_rng(seed), base, blobs, 3)
            want = ref_fuzz._corrupt(np.random.default_rng(seed), base,
                                     blobs, 3)
            assert got != base, seed
            if want == base:
                ref_noops += 1
            else:
                assert got == want, seed
    assert ref_noops > 0  # the fix is exercised


@pytest.mark.parametrize("stream", [b"\x00" * 20 + b"\xff",
                                    b"\x01\xff\x02", b"\xff"])
def test_mode_3_marker_at_the_end(stream):
    for seed in range(50):
        out = fuzz._corrupt(np.random.default_rng(seed), stream, [stream], 3)
        assert len(out) == len(stream) and out != stream


def test_replay_trial_30795_is_unchanged(corpus):
    """tests/test_fuzz_tool.py replays trial 30795, a mode-3 trial on a
    JPEG stream: the reference's flips land there, so the port's mode-3
    fix leaves that trial's bytes as the reference's."""
    t = 30795
    blobs = [s for _, s in corpus]
    fam, base = corpus[t % len(corpus)]
    got = fuzz._corrupt(np.random.default_rng(77000 + t), base, blobs, t % 4)
    want = ref_fuzz._corrupt(np.random.default_rng(77000 + t), base, blobs,
                             t % 4)
    assert (fam, t % 4) == ("jpeg", 3)
    assert want != base and got == want


def test_short_campaign_all_families(capsys):
    assert fuzz.main(["--trials", "30", "--device", "cpu"]) == 0
    assert '"failures": 0' in capsys.readouterr().out


def test_device_engine_campaign(capsys):
    """The decoders' kernel lanes (plain torch on the CPU)."""
    assert fuzz.main(["--trials", "60", "--device", "cpu", "--engine",
                      "device"]) == 0
    assert '"failures": 0' in capsys.readouterr().out


def test_only_replay_single_trial(capsys):
    assert fuzz.main(["--only", "30795", "--device", "cpu"]) == 0
    assert '"trials": 1' in capsys.readouterr().out


def test_no_families_selected():
    assert fuzz.main(["--trials", "5", "--families", "nope",
                      "--device", "cpu"]) == 2
