"""DICOM transfer-syntax UID constants for the 12 registered codecs.

The reference registers these UIDs via the external go-dicom ``transfer``
package (see SURVEY.md §2.1; reference rle/rle.go:414,
jpeg/baseline/codec.go:181-188, jpeg2000/htj2k/codec.go:289-310). The UID
values themselves are DICOM PS3.5 standard constants.
"""

# Uncompressed (used as decode targets)
IMPLICIT_VR_LITTLE_ENDIAN = "1.2.840.10008.1.2"
EXPLICIT_VR_LITTLE_ENDIAN = "1.2.840.10008.1.2.1"

# RLE (reference rle/rle.go:414)
RLE_LOSSLESS = "1.2.840.10008.1.2.5"

# Classic JPEG (reference jpeg/*/codec.go)
JPEG_BASELINE_8BIT = "1.2.840.10008.1.2.4.50"       # Process 1 (SOF0)
JPEG_EXTENDED_12BIT = "1.2.840.10008.1.2.4.51"      # Process 2 & 4 (SOF1)
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"        # Process 14 (SOF3)
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"        # Process 14 SV1 (pred 1)

# JPEG-LS (reference jpegls/*/codec.go)
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR_LOSSLESS = "1.2.840.10008.1.2.4.81"

# JPEG 2000 Part 1 (reference jpeg2000/{lossless,lossy}/codec.go)
JPEG_2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG_2000_LOSSY = "1.2.840.10008.1.2.4.91"

# JPEG 2000 Part 2 multi-component (reference jpeg2000/lossless/codec.go:306-322)
JPEG_2000_MC_LOSSLESS = "1.2.840.10008.1.2.4.92"
JPEG_2000_MC_LOSSY = "1.2.840.10008.1.2.4.93"

# HTJ2K Part 15 (reference jpeg2000/htj2k/codec.go:289-310)
HTJ2K_LOSSLESS = "1.2.840.10008.1.2.4.201"
HTJ2K_LOSSLESS_RPCL = "1.2.840.10008.1.2.4.202"
HTJ2K = "1.2.840.10008.1.2.4.203"

ALL_CODEC_UIDS = (
    RLE_LOSSLESS,
    JPEG_BASELINE_8BIT,
    JPEG_EXTENDED_12BIT,
    JPEG_LOSSLESS_P14,
    JPEG_LOSSLESS_SV1,
    JPEG_LS_LOSSLESS,
    JPEG_LS_NEAR_LOSSLESS,
    JPEG_2000_LOSSLESS,
    JPEG_2000_LOSSY,
    JPEG_2000_MC_LOSSLESS,
    JPEG_2000_MC_LOSSY,
    HTJ2K_LOSSLESS,
    HTJ2K_LOSSLESS_RPCL,
    HTJ2K,
)
