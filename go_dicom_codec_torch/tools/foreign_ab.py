"""Same-stream decode A/B against OpenJPEG (via PIL).

Port of ``go_dicom_codec_tpu/tools/foreign_ab.py``: both decoders decode
the SAME codestream bytes, interleaved, medians reported. The port's
encoder and decoder run on ``--device`` (default cuda, which is cuda:0)
with ``--engine``. Needs PIL; without it the tool raises its
ImportError.

Usage: python -m go_dicom_codec_torch.tools.foreign_ab [--rounds N]
    [--size N] [--device cuda|cuda:N|cpu] [--engine auto|device|host]
Prints one AB| JSON line per (codec, content) row.
"""

from __future__ import annotations

import argparse
import io
import json
import statistics
import time


def _frames(size: int):
    import numpy as np
    rng = np.random.default_rng(7)
    dense = rng.integers(0, 4096, size=(size, size)).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size]
    textured = (((np.sin(xx / 9.0) + np.cos(yy / 13.0)) * 512 + 2048)
                .astype(np.int32)
                + rng.integers(-64, 65, size=(size, size)).astype(np.int32))
    textured = np.clip(textured, 0, 4095)
    return {"dense": dense, "textured": textured}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--device", default="cuda",
                    help="where the port's codec runs: cuda (cuda:0), "
                         "cuda:N or cpu")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "device", "host"))
    args = ap.parse_args(argv)

    import numpy as np
    from PIL import Image

    from ..codecs.jpeg2000 import J2KDecoder, J2KEncodeParams, J2KEncoder
    from . import cli_device

    on = dict(device=cli_device(args.device), engine=args.engine)
    rows = []
    for content, img in _frames(args.size).items():
        for codec, kw in (("j2k", {}), ("htj2k", dict(htj2k=True)),
                          ("htj2k-refined", dict(htj2k=True,
                                                 ht_refinement=True))):
            p = J2KEncodeParams(**kw)
            s = J2KEncoder(p, **on).encode(img, img.shape[1], img.shape[0],
                                           1, 12)
            # verify both agree before timing
            ours = np.squeeze(J2KDecoder(**on).decode(s)[0])
            pil = np.array(Image.open(io.BytesIO(s))).astype(np.int64) >> 4
            assert np.array_equal(ours, img) and np.array_equal(pil, img), \
                (codec, content)
            t_us, t_them = [], []
            for _ in range(args.rounds):
                t0 = time.perf_counter()
                J2KDecoder(**on).decode(s)
                t_us.append((time.perf_counter() - t0) * 1000)
                t0 = time.perf_counter()
                np.array(Image.open(io.BytesIO(s)))
                t_them.append((time.perf_counter() - t0) * 1000)
            row = {"codec": codec, "content": content,
                   "stream_bytes": len(s),
                   "ours_ms": round(statistics.median(t_us), 2),
                   "openjpeg_ms": round(statistics.median(t_them), 2),
                   "device": str(on["device"]), "engine": args.engine}
            row["speedup"] = round(row["openjpeg_ms"] / row["ours_ms"], 2)
            rows.append(row)
            print("AB|" + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
