"""Reproducible corruption-fuzz campaign over every decode surface.

Port of ``go_dicom_codec_tpu/tools/fuzz.py``. Seeds are fixed per trial
index, so any failure reproduces with --only TRIAL.

Every trial corrupts a valid stream (byte flips, truncation, a splice of
two streams, or a flip of the bytes after a 0xFF marker) and requires the
decoder to end in clean pixels or a TYPED codec error — never a crash,
hang, or foreign exception — in both strict and resilient modes where
the codec has them. The transcode sniffer must classify every corpus
without raising. The corpus is encoded, and the J2K and DCT JPEG decoders
run, on ``--device`` (default cuda, which is cuda:0) with ``--engine``:
on "device" a J2K decode reaches the fused inverse stage
(csrc/j2k_inv_stage.cu) and a sequential DCT JPEG decode the islow inverse
(csrc/jpeg_islow.cu), so hostile geometry reaches the kernels. A refused
launch (``KernelLaunchError``) or a CUDA error is a failure like any other
foreign exception.

Modes 0-2 draw the reference's bytes for the same seed. Mode 3 does too
wherever the reference's flips land; where the chosen 0xFF lies so close
to the end that none does (or two flips cancel), the port flips one more
byte, so no mode-3 trial leaves its stream as it was.

Usage:
    python -m go_dicom_codec_torch.tools.fuzz [--trials N] [--only T]
        [--families j2k,jpeg,jls,rle] [--seed-base B]
        [--device cuda|cuda:N|cpu] [--engine auto|device|host]
Prints FUZZ| JSON lines; exit 1 on any failure, 2 when no family is
selected. --seed-base (default 77000) offsets every trial's RNG stream so
fresh campaigns explore new corruption space while staying replayable: a
failure at trial T under base B reproduces with `--seed-base B --only T`.
The summary line records the base used.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

FAMILIES = ("j2k", "jpeg", "jls", "rle")


def _corrupt(rng, base: bytes, others, mode: int) -> bytes:
    b = bytearray(base)
    if mode == 0:
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        return bytes(b)
    if mode == 1:
        return bytes(b[:int(rng.integers(1, len(b)))])
    if mode == 3:
        # marker-targeted: mutate the bytes right after a 0xFF marker
        # (segment lengths / header fields), which reaches parser edge
        # cases uniform flips hit only rarely
        marks = [i for i, v in enumerate(b) if v == 0xFF]
        if marks:
            at = marks[int(rng.integers(0, len(marks)))]
            for _ in range(int(rng.integers(1, 5))):
                j = at + 1 + int(rng.integers(0, 8))
                if j < len(b):
                    b[j] ^= int(rng.integers(1, 256))
            if b == base:
                # no flip landed (0xFF within 8 bytes of the end) or two
                # cancelled: flip the byte after the marker, or the
                # marker itself when it ends the stream
                b[min(at + 1, len(b) - 1)] ^= int(rng.integers(1, 256))
            return bytes(b)
        mode = 2  # no marker byte (can't happen in practice): splice
    other = others[int(rng.integers(0, len(others)))]
    cut = int(rng.integers(0, min(len(b), len(other))))
    return bytes(b[:cut]) + bytes(other[cut:])


def build_corpus(families, device: torch.device, engine: str = "auto"):
    """The valid streams the trials corrupt, as [(family, bytes)], in the
    reference's order; J2K and DCT JPEG streams are encoded on ``device``
    with ``engine``."""
    fams = set(families)
    rng0 = np.random.default_rng(20260819)
    img = rng0.integers(0, 4096, (64, 64)).astype(np.int32)
    img8 = (img % 251).astype(np.uint8)

    corpus = []  # (family, bytes)
    if "j2k" in fams:
        from ..codecs.jpeg2000 import J2KEncodeParams, J2KEncoder
        from ..codestream import j2k
        for kw in (dict(), dict(htj2k=True),
                   dict(htj2k=True, ht_refinement=True),
                   dict(lossless=False, quality=60),
                   dict(packed_headers=True, use_sop=True, use_eph=True,
                        plt_markers=True),
                   dict(tile_width=32, tile_height=32, tlm_markers=True),
                   dict(progression=j2k.PROG_PCRL, num_layers=2)):
            s = J2KEncoder(J2KEncodeParams(
                num_levels=2, cb_width=32, cb_height=32, **kw),
                device=device, engine=engine).encode(img, 64, 64, 1, 12)
            corpus.append(("j2k", s))
            corpus.append(("j2k", j2k.wrap_jp2(
                s, brand="jph" if kw.get("htj2k") else "jp2")))
        rgb = np.stack([img % 256, (img // 16) % 256,
                        (img // 7) % 256], axis=-1).astype(np.int32)
        corpus.append(("j2k", J2KEncoder(J2KEncodeParams(
            num_levels=2, cb_width=32, cb_height=32), device=device,
            engine=engine).encode(rgb.reshape(-1, 3), 64, 64, 3, 8)))
    rgb8 = np.stack([img8, (img8 * 3) % 251, (img8 * 7) % 251],
                    axis=-1).astype(np.uint8)
    if "jpeg" in fams:
        from ..codecs import jpeg_baseline, jpeg_extended, jpeg_lossless
        on = dict(device=device, engine=engine)
        corpus.append(("jpeg", jpeg_baseline.encode(
            img8.tobytes(), 64, 64, 1, 90, **on)))
        corpus.append(("jpeg", jpeg_baseline.encode(
            rgb8.reshape(-1, 3).tobytes(), 64, 64, 3, 75, **on)))
        corpus.append(("jpeg", jpeg_extended.encode(
            (img % 4096).astype("<u2").tobytes(), 64, 64, 1, 12, **on)))
        corpus.append(("jpeg", jpeg_lossless.encode(
            (img % 4096).astype("<u2").tobytes(), 64, 64, 1, 12,
            predictor=4)))
        corpus.append(("jpeg", jpeg_lossless.encode(
            (img % 65536).astype("<u2").tobytes(), 64, 64, 1, 16,
            predictor=7)))
        # SV1-shaped stream: predictor 1, multi-component 8-bit
        corpus.append(("jpeg", jpeg_lossless.encode(
            rgb8.reshape(-1, 3).tobytes(), 64, 64, 3, 8, predictor=1)))
    if "jls" in fams:
        from ..codecs import jpegls
        corpus.append(("jls", jpegls.encode(
            (img % 4096).astype("<u2").tobytes(), 64, 64, 1, 12)))
        corpus.append(("jls", jpegls.encode(
            (img % 4096).astype("<u2").tobytes(), 64, 64, 1, 12, near=2)))
        # all three T.87 interleave modes over a 3-component frame
        for ilv in (0, 1, 2):
            corpus.append(("jls", jpegls.encode(
                rgb8.reshape(-1, 3).tobytes(), 64, 64, 3, 8, ilv=ilv)))
    if "rle" in fams:
        from ..codecs import rle
        from ..frames import FrameInfo
        info = FrameInfo(width=64, height=64, bits_allocated=16,
                         bits_stored=12)
        corpus.append(("rle", rle.encode_frame(
            (img % 4096).astype("<u2").tobytes(), info)))
    return corpus


def decoders_for(fam: str, device: torch.device, engine: str = "auto"):
    """The decode surfaces a trial of family ``fam`` goes through."""
    if fam == "j2k":
        from ..codecs.jpeg2000 import J2KDecoder
        on = dict(device=device, engine=engine)
        return [lambda d: J2KDecoder(**on).decode(d),
                lambda d: J2KDecoder(resilient=True, **on).decode(d),
                lambda d: J2KDecoder(resilient=True, reduce=1,
                                     **on).decode(d),
                lambda d: J2KDecoder(resilient=True, window=(8, 8, 40, 40),
                                     **on).decode(d)]
    if fam == "jpeg":
        from ..codecs import (jpeg_baseline, jpeg_extended,
                              jpeg_lossless, jpeg_progressive)
        return [lambda d: jpeg_baseline.decode(d, device=device,
                                               engine=engine),
                lambda d: jpeg_extended.decode(d, device=device,
                                               engine=engine),
                lambda d: jpeg_lossless.decode(d),
                lambda d: jpeg_progressive.decode(d)]
    if fam == "jls":
        from ..codecs import jpegls
        return [lambda d: jpegls.decode(d)]
    from ..codecs import rle
    from ..frames import FrameInfo
    info = FrameInfo(width=64, height=64, bits_allocated=16,
                     bits_stored=12)
    return [lambda d: rle.decode_frame(d, info)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=2000)
    ap.add_argument("--only", type=int, default=None,
                    help="re-run a single trial index")
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--seed-base", type=int, default=77000)
    ap.add_argument("--device", default="cuda",
                    help="where the codecs run: cuda (cuda:0), cuda:N or "
                         "cpu")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "device", "host"))
    args = ap.parse_args(argv)
    fams = set(args.families.split(","))

    from ..errors import CodecError
    from . import cli_device
    from . import transcode as tc

    device = cli_device(args.device)
    corpus = build_corpus(fams, device, args.engine)
    if not corpus:
        print("no families selected", file=sys.stderr)
        return 2
    blobs = [c[1] for c in corpus]
    decoders = {fam: decoders_for(fam, device, args.engine)
                for fam in {c[0] for c in corpus}}

    trials = [args.only] if args.only is not None else range(args.trials)
    fails = 0
    t0 = time.time()
    for t in trials:
        rng = np.random.default_rng(args.seed_base + t)
        fam, base = corpus[t % len(corpus)]
        data = _corrupt(rng, base, blobs, t % 4)
        for dec in decoders[fam]:
            try:
                dec(data)
            except CodecError:
                pass
            except Exception as e:  # noqa: BLE001
                print(f"FUZZ|FAIL trial={t} family={fam} "
                      f"{type(e).__name__}: {e}", flush=True)
                fails += 1
        try:
            tc.sniff(data)
        except Exception as e:  # noqa: BLE001
            print(f"FUZZ|SNIFF-FAIL trial={t}: {type(e).__name__}: {e}",
                  flush=True)
            fails += 1
    print("FUZZ|" + json.dumps({
        "trials": len(list(trials)), "families": sorted(fams),
        "corpus_streams": len(corpus), "seed_base": args.seed_base,
        "device": str(device), "engine": args.engine,
        "failures": fails, "seconds": round(time.time() - t0, 1)}))
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
