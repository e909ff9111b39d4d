"""Batched ops: torch device ops, and one numpy module.

Each module mirrors the module of the same name in
``go_dicom_codec_tpu/ops``, except ``fdct8x8_quant`` (the port of
``pallas_dct``), ``j2k_fwd_stage`` and ``j2k_inv_stage`` (the J2K forward
and reversible decode stages of ``go_dicom_codec_tpu/pipeline.py``, each
in one kernel) and ``jpeg_islow`` (the JPEG codecs' islow DCT stages of
``dct8x8``, one kernel each way). ``lossless_predict`` is the reference's
numpy module, copied byte for byte (the lossless JPEG codec imports it by
this path); ``planes`` and ``dct8x8`` hold numpy forms beside their torch
ones. Plain-torch functions
run on any device and are the reference of the hand-written kernels; a
kernel wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor.
"""
