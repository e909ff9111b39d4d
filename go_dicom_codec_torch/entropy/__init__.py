"""Host-side sequential entropy coders.

The compute-dense transforms run on TPU (see ``ops/``); the byte-stream
entropy stages here are inherently serial and run host-side, vectorized with
numpy where the format allows (SURVEY.md north star: entropy host-side,
overlapped with device work).
"""
