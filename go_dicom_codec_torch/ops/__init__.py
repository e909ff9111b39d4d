"""Batched device ops on torch tensors.

Each module mirrors the module of the same name in
``go_dicom_codec_tpu/ops``. Plain-torch functions run on any device and are
the reference of the hand-written kernels; a kernel wrapper launches its
kernel for a CUDA tensor and runs the plain version for a CPU tensor.
"""
