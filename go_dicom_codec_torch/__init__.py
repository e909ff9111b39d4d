"""PyTorch + CUDA port of the DICOM pixel-data codec framework.

This package runs the device half of the batched JPEG 2000 lossless
transform (DC shift, RCT, multilevel reversible 5/3 DWT, code-block
stats, and the inverse) and the fused 8×8 DCT + quant benchmark kernel
on an NVIDIA Hopper GPU. ``go_dicom_codec_tpu`` is the JAX reference; each
module here mirrors the module of the same path there.

Layout:
  - ``ops/``      plain-torch functions (the CPU lane and the kernels'
                  reference) and the wrappers of the hand-written kernels.
  - ``csrc/``     the CUDA C++ kernels, built with ``nvcc`` at first use.
  - ``pipeline``  the device stages of the encode and decode pipelines.
  - ``tools/``    the device bench.

Every kernel wrapper launches its kernel for a CUDA tensor and runs the
plain version for a CPU tensor; any other device raises. Importing the
package builds nothing and imports neither ``jax`` nor the JAX package.
"""

__version__ = "0.1.0"
