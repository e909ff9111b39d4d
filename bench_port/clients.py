"""A client of a cell, one to a worker process (``worker.py``): it builds
its own registry and corpus, warms its calls and then runs a closed loop
of codec calls until the deadline.

A client drives ``make_registry(device, engine=...)`` and the codec of
its configuration's transfer syntax, with ``MemoryPixelData`` objects
this module builds from the phantom. It keeps a record of every call and
the outputs of a sample of them drawn from the seed, for the check after
the window.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from . import phantom


def now() -> float:
    return time.perf_counter()


class Client:
    """One closed-loop client of a cell."""

    def __init__(self, index: int, seed: int, cfg: dict, mix: dict,
                 device, gdc, control: bool = False) -> None:
        self.index, self.seed, self.cfg, self.mix = index, seed, cfg, mix
        self.gdc, self.device = gdc, device
        self.op = mix["op"]
        frame = cfg["frame"]
        self.info = gdc.FrameInfo(
            width=frame["columns"], height=frame["rows"],
            bits_allocated=frame["bits_allocated"],
            bits_stored=frame["bits_stored"],
            samples_per_pixel=frame["samples_per_pixel"],
            pixel_representation=1 if frame["signed"] else 0)
        self.registry = gdc.make_registry(device, engine=cfg["engine"])
        # the control runs the program's lossy path of the same family in
        # place of the lossless one (bench_port/control.py)
        # with the configuration's parameters and the control's on top
        syntax = cfg["control"] if control else cfg
        self.uid = syntax["transfer_syntax"]
        self.params = self._parameters({**cfg.get("parameters", {}),
                                        **syntax.get("parameters", {})})
        self.codec = self.registry.get_codec(self.uid)
        self.calls: List[dict] = []
        self.kept: List[tuple] = []
        self.errors: List[str] = []
        self._keep_rng = np.random.default_rng([int(seed), index, 3])
        self._keep_max = int(mix["check"].get("calls_per_client", 0))
        # an encode's output of each object: the first timed one, and the
        # frames of later calls that differ from it
        self.first: dict = {}
        self.differing = 0
        self.frames: Optional[np.ndarray] = None
        self.inputs: list = []

    def _parameters(self, values: dict):
        return self.gdc.Parameters(**values) if values else None

    # ---- set-up ---------------------------------------------------------

    def make_corpus(self) -> None:
        """The client's frames: ``objects_per_client`` objects of
        ``frames_per_call`` consecutive slices each."""
        n, per = int(self.mix["objects_per_client"]), \
            int(self.mix["frames_per_call"])
        slices = phantom.ct_slices(self.seed, self.index, n * per,
                                   self.cfg["phantom"])
        self.frames = slices.reshape(n, per, *slices.shape[1:])

    def _raw(self, frames: np.ndarray):
        src = self.gdc.MemoryPixelData(info=self.info)
        for f in frames:
            src.add_frame(np.ascontiguousarray(f).astype("<u2").tobytes())
        return src

    def encode_corpus(self) -> None:
        """The call inputs: raw objects for an encode, streams the
        program encodes here for a decode. Single-frame objects are
        encoded as one series and split, one stream an object."""
        objects = [self._raw(f) for f in self.frames]
        if self.op == "encode":
            self.inputs = objects
            return
        if len(objects[0].frames) == 1:
            series = self._raw(self.frames[:, 0])
            enc = self.gdc.MemoryPixelData(info=self.info, encapsulated=True)
            self.codec.encode(series, enc, self.params)
            self.inputs = []
            for stream in enc.frames:
                one = self.gdc.MemoryPixelData(info=self.info,
                                               encapsulated=True)
                one.add_frame(stream)
                self.inputs.append(one)
            return
        self.inputs = []
        for src in objects:
            enc = self.gdc.MemoryPixelData(info=self.info, encapsulated=True)
            self.codec.encode(src, enc, self.params)
            self.inputs.append(enc)

    def compressed_bytes_per_frame(self) -> float:
        streams = [s for obj in self.inputs for s in obj.frames] \
            if self.op == "decode" else []
        return float(np.mean([len(s) for s in streams])) if streams else 0.0

    # ---- calls ----------------------------------------------------------

    def call(self, k: int):
        """The timed unit: one codec call on object ``k`` mod the
        objects; returns the output object."""
        src = self.inputs[k % len(self.inputs)]
        if self.op == "decode":
            out = self.gdc.MemoryPixelData(info=self.info)
            self.codec.decode(src, out, self.params)
        else:
            out = self.gdc.MemoryPixelData(info=self.info, encapsulated=True)
            self.codec.encode(src, out, self.params)
        return out

    def release(self) -> None:
        """Drop the program's state once the window has closed; the kept
        outputs and the frames stay for the check."""
        self.inputs = []
        self.codec = self.registry = None

    def expected(self, k: int) -> np.ndarray:
        return self.frames[k % len(self.frames)]
    def loop(self, start: float, deadline: float) -> None:
        """Closed loop: the next call starts when the last returns, until
        the deadline; a call that raises is recorded as failed."""
        while now() < start:
            time.sleep(min(0.001, max(0.0, start - now())))
        k = 0
        while True:
            t0 = now()
            if t0 >= deadline:
                break
            out, ok = None, True
            try:
                out = self.call(k)
            except Exception as exc:  # noqa: BLE001 - a failed call counts
                ok = False
                self.errors.append(f"{type(exc).__name__}: {exc}")
            t1 = now()
            frames = len(out.frames) if out is not None else 0
            self.calls.append({"client": self.index, "op": self.op,
                               "t0": t0, "t1": t1, "frames": frames,
                               "ok": ok})
            if ok:
                self._keep(k, out)
            k += 1

    def _keep(self, k: int, out) -> None:
        """An encode keeps the first output of each object and counts the
        frames of every later output that are not byte for byte the same.
        A decode keeps a sample of the calls' outputs, uniform over the
        window and drawn from the seed (reservoir sampling)."""
        if self.op == "encode":
            obj = k % len(self.inputs)
            first = self.first.setdefault(obj, out.frames)
            if first is not out.frames:
                self.differing += max(len(first), len(out.frames)) - sum(
                    a == b for a, b in zip(first, out.frames))
            return
        if len(self.kept) < self._keep_max:
            self.kept.append((k, out))
            return
        j = int(self._keep_rng.integers(0, k + 1))
        if j < self._keep_max:
            self.kept[j] = (k, out)


def set_native_threads(n: int) -> None:
    """The native T1/T2 pool reads GDCT_THREADS at every call."""
    os.environ["GDCT_THREADS"] = str(int(n))
