"""WebP's lossy bitstream (a VP8 key frame, RFC 6386), as libwebp 1.6's
src/dec/ decodes it and WebPAnimDecoder converts it (MODE_RGBA), with no
PIL and no libwebp.

The frame decode runs in C++ (csrc/webp.cpp `lrt_vp8_frame`, built at
first use by host_build.compile_shared; a failed build raises, and
nothing falls back); `_frame_plain` is its plain Python version with the
same contract.  It reads the frame and partition headers; segments with
their quantiser and filter values (absolute or deltas); the loop-filter
header with sharpness and the reference/mode deltas; the token
partitions; the coefficient-probability updates; per macroblock the
segment, skip flag and intra modes (16x16, or sixteen 4x4 modes from
their above/left contexts, and chroma), then the tokens through the
boolean decoder (libwebp's eof rule: a read past the end flags the
partition, and the frame fails), dequantised as libwebp stores them
(int16).  Reconstruction follows libwebp's work buffer: above the frame
127, left of it 129, the corner 127 on the first row and 129 below, the
4x4 blocks' above-right samples from the next macroblock's top row (the
last column repeats its own), the DC modes without top or left samples
at the frame's edges, the inverse WHT and DCT with libwebp's rounding;
prediction reads unfiltered samples.  The simple or normal loop filter
then runs over the frame in macroblock order (per-segment levels, the
4x4 mode delta, hev thresholds, inner edges where the macroblock has
4x4 modes or coefficients).

`yuv_to_rgb` is libwebp's fancy upsampler (the first and last rows and
columns as EmitFancyRGB and UpsampleRgbaLinePair treat them) and its
14-bit fixed-point VP8YUVToR/G/B, in numpy.
"""
from __future__ import annotations

import numpy as np

from .vp8l import library

# CoeffsProba0: the default coefficient probabilities [4][8][3][11]
_COEFFS0 = (
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254,
    255, 228, 219, 128, 128, 128, 128, 128, 189, 129, 242, 255, 227, 213, 255, 219, 128, 128,
    128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226,
    255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134,
    202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128,
    128, 128, 184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236,
    230, 128, 128, 128, 128, 128, 1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170,
    139, 241, 252, 236, 209, 255, 255, 128, 128, 128, 37, 116, 196, 243, 228, 255, 255, 255,
    128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255,
    238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128,
    128, 128, 128, 128, 80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255,
    128, 128, 128, 128, 128, 128, 128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 198, 35, 237, 223, 193, 187,
    162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68, 47,
    146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128,
    128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176,
    190, 249, 202, 255, 255, 128, 1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99,
    121, 210, 250, 201, 198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210,
    255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255,
    231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255,
    255, 128, 128, 128, 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249,
    255, 232, 235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128, 128, 128, 128,
    128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128, 1, 157, 247, 255, 236, 231,
    255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128, 45, 99,
    188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128,
    128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224,
    255, 128, 128, 128, 128, 128, 253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175,
    13, 224, 243, 193, 185, 249, 198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167,
    255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250,
    211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128,
    128, 128, 128, 128, 69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251,
    255, 255, 128, 128, 128, 128, 128, 128, 223, 165, 249, 255, 213, 255, 128, 128, 128, 128,
    128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128, 1, 16, 248, 255, 255, 128,
    128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128, 149, 1,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128,
    128, 128, 128, 128, 128, 128, 1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213,
    62, 250, 255, 255, 128, 128, 128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228,
    174, 255, 187, 128, 61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230,
    250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252, 211, 215, 255, 174, 128, 128,
    128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52, 220, 246, 198, 199,
    249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128, 24, 71,
    130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128,
    128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183,
    194, 254, 223, 255, 255, 128, 1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123,
    102, 209, 247, 188, 196, 255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203,
    128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252,
    235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255,
    219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255,
    128, 128, 128, 128, 128, 128, 128, 128, 244, 1, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,)
# CoeffsUpdateProba: the probabilities of their updates
_COEFFS_UPDATE = (
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 223, 241, 252, 255, 255, 255, 255, 255, 255, 255,
    255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255,
    255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255, 234, 250,
    241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 255, 255,
    255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234,
    251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254, 255, 254, 255,
    255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255,
    255, 255, 255, 255, 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253,
    255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 252, 255, 255, 255,
    255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252,
    253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,)
# kBModesProba[above][left][9]: the 4x4 mode tree's probabilities
_BMODES = (
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,)
# kDcTable, kAcTable: dequantisation steps by quantiser index
_DC = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,)
_AC = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,)
TABLES = np.array(_COEFFS0 + _COEFFS_UPDATE + _BMODES + _DC + _AC, np.int32)
_P0, _UPD, _BM, _DCO, _ACO = 0, 1056, 2112, 3012, 3140


def header(body: bytes, chunk_size: int):
    """VP8GetInfo -> (width, height); OSError when libwebp refuses it."""
    if len(body) < 10 or body[3:6] != b"\x9d\x01\x2a":
        raise OSError("VP8: not a key frame bitstream")
    bits = body[0] | (body[1] << 8) | (body[2] << 16)
    w = ((body[7] << 8) | body[6]) & 0x3FFF
    h = ((body[9] << 8) | body[8]) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 \
            or bits >> 5 >= chunk_size or not w or not h:
        raise OSError("VP8: an invalid frame header")
    return w, h


def decode(body: bytes, plain: bool = False) -> np.ndarray:
    """A `VP8 ` chunk's payload -> (H, W, 3) uint8 RGB."""
    y, u, v, w, h = (_frame_plain if plain else frame)(body)
    return yuv_to_rgb(y[:h, :w], u[:(h + 1) // 2, :(w + 1) // 2],
                      v[:(h + 1) // 2, :(w + 1) // 2])


def _planes(body):
    w = ((body[7] << 8) | body[6]) & 0x3FFF if len(body) >= 10 else 0
    h = ((body[9] << 8) | body[8]) & 0x3FFF if len(body) >= 10 else 0
    mw, mh = (w + 15) >> 4, (h + 15) >> 4
    return (np.zeros((16 * mh, 16 * mw), np.uint8),
            np.zeros((8 * mh, 8 * mw), np.uint8),
            np.zeros((8 * mh, 8 * mw), np.uint8), w, h)


def frame(body: bytes):
    """lrt_vp8_frame -> the macroblock-sized (Y, U, V) planes, w, h."""
    y, u, v, w, h = _planes(body)
    info = np.zeros(4, np.int32)
    buf = np.frombuffer(body, np.uint8)
    r = library().lrt_vp8_frame(buf.ctypes.data, len(body), TABLES.ctypes.data,
                                y.ctypes.data, u.ctypes.data, v.ctypes.data,
                                info.ctypes.data)
    if r < 0:
        raise OSError(f"failed to read next frame (VP8 error {r})")
    return y, u, v, w, h


def _rgb(y, u, v):
    """VP8YUVToR/G/B: 14-bit fixed point (MultHi = x * c >> 8), clipped."""
    y, u, v = (a.astype(np.int32) for a in (y, u, v))
    yy = (y * 19077) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6,
                        np.where(x < 0, 0, 255)).astype(np.uint8)

    return np.stack([clip8(yy + ((v * 26149) >> 8) - 14234),
                     clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8)
                           + 8708),
                     clip8(yy + ((u * 33050) >> 8) - 17685)], -1)


def _upsample_rows(top, cur, bottom: bool, w: int):
    """UpsampleRgbaLinePair's chroma for one output row from the chroma
    rows above (top) and below (cur): (rows, w)."""
    top, cur = top.astype(np.int32), cur.astype(np.int32)
    near, far = (cur, top) if bottom else (top, cur)
    out = np.zeros((top.shape[0], w), np.int32)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    n = (w - 1) >> 1
    if n:
        tl, t = top[:, :n], top[:, 1:n + 1]
        lf, c = cur[:, :n], cur[:, 1:n + 1]
        avg = tl + t + lf + c + 8
        d12 = (avg + 2 * (t + lf)) >> 3
        d03 = (avg + 2 * (tl + c)) >> 3
        if bottom:
            out[:, 1:2 * n:2] = (d03 + lf) >> 1
            out[:, 2:2 * n + 1:2] = (d12 + c) >> 1
        else:
            out[:, 1:2 * n:2] = (d12 + tl) >> 1
            out[:, 2:2 * n + 1:2] = (d03 + t) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * near[:, n] + far[:, n] + 2) >> 2
    return out


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(H, W) luma and ((H+1)//2, (W+1)//2) chroma -> (H, W, 3) RGB as
    WebPAnimDecoder's MODE_RGBA output: row 0 from chroma row 0 alone,
    rows 2k-1 and 2k from chroma rows k-1 and k, the last row of an even
    height from the last chroma row alone."""
    h, w = y.shape
    r = np.arange(h)
    k = (r + 1) // 2
    above = np.maximum(k - 1, 0)
    below = np.minimum(k, u.shape[0] - 1)
    near_top = (r & 1) | (r == 0)      # rows 0 and 2k - 1
    uu = np.zeros((h, w), np.int32)
    vv = np.zeros((h, w), np.int32)
    for sel, bottom in ((near_top == 1, False), (near_top == 0, True)):
        uu[sel] = _upsample_rows(u[above[sel]], u[below[sel]], bottom, w)
        vv[sel] = _upsample_rows(v[above[sel]], v[below[sel]], bottom, w)
    return _rgb(y, uu, vv)




# ------------------------------------------------ the plain version ----
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
_YMODES4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
BPS = 32


class _Bool:
    """lrt_vp8_frame's boolean decoder."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.value, self.range, self.bits, self.eof = 0, 254, -8, False
        self._load()

    def _load(self):
        if self.pos < len(self.data):
            self.bits += 8
            self.value = self.data[self.pos] | (self.value << 8)
            self.pos += 1
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        r, pos = self.range, self.bits
        split = (r * prob) >> 8
        b = (self.value >> pos) > split
        if b:
            r -= split
            self.value -= (split + 1) << pos
        else:
            r = split + 1
        shift = 0
        while (r << shift) < 128:
            shift += 1
        self.bits -= shift
        self.range = (r << shift) - 1
        return int(b)

    def get(self, n: int) -> int:
        v = 0
        for k in range(n - 1, -1, -1):
            v |= self.bit(0x80) << k
        return v

    def sget(self, n: int) -> int:
        v = self.get(n)
        return -v if self.bit(0x80) else v


def _i16(x: int) -> int:
    return ((x + 32768) & 0xFFFF) - 32768


def _large(br: _Bool, p) -> int:
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    b1 = br.bit(p[8])
    cat = 2 * b1 + br.bit(p[9 + b1])
    v = 0
    for pr in _CAT[cat]:
        v += v + br.bit(pr)
    return v + 3 + (8 << cat)


def _coeffs(br, probs, ctx, dq, n, out, o):
    """get_coeffs: tokens into out[o:o + 16] -> the index after the last."""
    p = probs[_BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            p = probs[_BANDS[n]][0]
            if n == 16:
                return 16
        pc = probs[_BANDS[n + 1]]
        if not br.bit(p[2]):
            v, p = 1, pc[1]
        else:
            v, p = _large(br, p), pc[2]
        s = -v if br.bit(0x80) else v
        out[o + _ZIGZAG[n]] = _i16(s * dq[n > 0])
        n += 1
    return 16


def _wht(dc, out):
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = \
            a0 + a1, a0 - a1, a3 + a2, a3 - a2
    for i in range(4):
        t = tmp[4 * i:4 * i + 4]
        d = t[0] + 3
        a0, a1, a2, a3 = d + t[3], t[1] + t[2], t[1] - t[2], d - t[3]
        for k, val in enumerate((a0 + a1, a3 + a2, a0 - a1, a3 - a2)):
            out[64 * i + 16 * k] = _i16(val >> 3)


def _m1(a):
    return ((a * 20091) >> 16) + a


def _m2(a):
    return (a * 35468) >> 16


def _clip8(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _transform(c, o, w, d):
    """TransformOne of c[o:o + 16] added to w at d (stride BPS)."""
    tmp = [0] * 16
    for i in range(4):
        a, b = c[o + i] + c[o + 8 + i], c[o + i] - c[o + 8 + i]
        cc = _m2(c[o + 4 + i]) - _m1(c[o + 12 + i])
        dd = _m1(c[o + 4 + i]) + _m2(c[o + 12 + i])
        tmp[4 * i:4 * i + 4] = (a + dd, b + cc, b - cc, a - dd)
    for i in range(4):
        dc = tmp[i] + 4
        a, b = dc + tmp[8 + i], dc - tmp[8 + i]
        cc = _m2(tmp[4 + i]) - _m1(tmp[12 + i])
        dd = _m1(tmp[4 + i]) + _m2(tmp[12 + i])
        q = d + i * BPS
        for x, val in enumerate((a + dd, b + cc, b - cc, a - dd)):
            w[q + x] = _clip8(w[q + x] + (val >> 3))


def _fill(w, d, size, v):
    for j in range(size):
        w[d + j * BPS:d + j * BPS + size] = [v] * size


def _pred_block(w, d, mode, size):
    sh = 5 if size == 16 else 4
    left = [w[d - 1 + j * BPS] for j in range(size)]
    top = w[d - BPS:d - BPS + size]
    if mode == 0:
        _fill(w, d, size, (sum(left) + sum(top) + size) >> sh)
    elif mode == 1:
        tl = w[d - BPS - 1]
        for j in range(size):
            w[d + j * BPS:d + j * BPS + size] = \
                [_clip8(t + left[j] - tl) for t in top]
    elif mode == 2:
        for j in range(size):
            w[d + j * BPS:d + j * BPS + size] = top
    elif mode == 3:
        for j in range(size):
            w[d + j * BPS:d + j * BPS + size] = [left[j]] * size
    elif mode == 4:
        _fill(w, d, size, (sum(left) + size // 2) >> (sh - 1))
    elif mode == 5:
        _fill(w, d, size, (sum(top) + size // 2) >> (sh - 1))
    else:
        _fill(w, d, size, 0x80)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(w, d, mode):
    X = w[d - 1 - BPS]
    I, J, K, L = (w[d - 1 + k * BPS] for k in range(4))
    A, B, C, D, E, F, G, H = w[d - BPS:d - BPS + 8]
    if mode == 0:
        _fill(w, d, 4, (4 + A + B + C + D + I + J + K + L) >> 3)
        return
    if mode == 1:
        _pred_block(w, d, 1, 4)
        return
    if mode == 2:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        g = [row] * 4
    elif mode == 3:
        g = [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                               _avg3(K, L, L))]
    else:
        g = [[0] * 4 for _ in range(4)]
        if mode == 4:        # RD: diagonals down-right
            e = [L, K, J, I, X, A, B, C, D]
            for y in range(4):
                for x in range(4):
                    k = 3 - y + x + 1
                    g[y][x] = _avg3(e[k - 1], e[k], e[k + 1])
        elif mode == 6:      # LD
            e = [A, B, C, D, E, F, G, H, H]
            for y in range(4):
                for x in range(4):
                    k = x + y
                    g[y][x] = _avg3(e[k], e[k + 1], e[k + 2])
        elif mode == 5:      # VR
            g[0] = [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)]
            g[1] = [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C),
                    _avg3(B, C, D)]
            g[2] = [_avg3(J, I, X)] + g[0][:3]
            g[3] = [_avg3(K, J, I)] + g[1][:3]
        elif mode == 7:      # VL
            g[0] = [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)]
            g[1] = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E),
                    _avg3(D, E, F)]
            g[2] = g[0][1:] + [_avg3(E, F, G)]
            g[3] = g[1][1:] + [_avg3(F, G, H)]
        elif mode == 8:      # HD
            g[0] = [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B),
                    _avg3(A, B, C)]
            g[1] = [_avg2(J, I), _avg3(J, I, X)] + g[0][:2]
            g[2] = [_avg2(K, J), _avg3(K, J, I)] + g[1][:2]
            g[3] = [_avg2(L, K), _avg3(L, K, J)] + g[2][:2]
        else:                # HU
            g[0] = [_avg2(I, J), _avg3(I, J, K), _avg2(J, K),
                    _avg3(J, K, L)]
            g[1] = [_avg2(J, K), _avg3(J, K, L), _avg2(K, L),
                    _avg3(K, L, L)]
            g[2] = [_avg2(K, L), _avg3(K, L, L), L, L]
            g[3] = [L, L, L, L]
    for y in range(4):
        w[d + y * BPS:d + y * BPS + 4] = g[y]


def _sclip1(v):
    return -128 if v < -128 else 127 if v > 127 else v


def _sclip2(v):
    return -16 if v < -16 else 15 if v > 15 else v


def _filter_edge(buf, p, step, kind, t, it=0, hev_t=0):
    """One position of an edge: kind 0 simple, 4 inner, 6 macroblock."""
    p1, p0, q0, q1 = buf[p - 2 * step], buf[p - step], buf[p], buf[p + step]
    t2 = 2 * t + 1
    if 4 * abs(p0 - q0) + abs(p1 - q1) > t2:
        return
    if kind:
        p3, p2 = buf[p - 4 * step], buf[p - 3 * step]
        q2, q3 = buf[p + 2 * step], buf[p + 3 * step]
        if max(abs(p3 - p2), abs(p2 - p1), abs(p1 - p0), abs(q3 - q2),
               abs(q2 - q1), abs(q1 - q0)) > it:
            return
    if not kind or abs(p1 - p0) > hev_t or abs(q1 - q0) > hev_t:
        a = 3 * (q0 - p0) + _sclip1(p1 - q1)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        buf[p - step], buf[p] = _clip8(p0 + a2), _clip8(q0 - a1)
    elif kind == 4:
        a = 3 * (q0 - p0)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        buf[p - 2 * step], buf[p - step] = _clip8(p1 + a3), _clip8(p0 + a2)
        buf[p], buf[p + step] = _clip8(q0 - a1), _clip8(q1 - a3)
    else:
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        p2, q2 = buf[p - 3 * step], buf[p + 2 * step]
        buf[p - 3 * step], buf[p - 2 * step] = _clip8(p2 + a3), _clip8(p1 + a2)
        buf[p - step], buf[p] = _clip8(p0 + a1), _clip8(q0 - a1)
        buf[p + step], buf[p + 2 * step] = _clip8(q1 - a2), _clip8(q2 - a3)


def _frame_plain(body: bytes):
    """lrt_vp8_frame's plain Python version -> (Y, U, V, w, h)."""
    def fail(code):
        return OSError(f"failed to read next frame (VP8 error {code})")

    if len(body) < 10:
        raise fail(-1)
    bits = body[0] | (body[1] << 8) | (body[2] << 16)
    part0 = bits >> 5
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1:
        raise fail(-2)
    if body[3:6] != b"\x9d\x01\x2a":
        raise fail(-3)
    yp, up, vp, width, height = _planes(body)
    mb_h, mb_w = yp.shape[0] // 16, yp.shape[1] // 16
    rest = body[10:]
    if part0 > len(rest):
        raise fail(-4)
    br = _Bool(rest[:part0])
    rest = rest[part0:]
    br.get(1)
    br.get(1)
    use_segment, update_map, absolute = br.get(1), 0, 1
    quant, fstrength, seg_p = [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = br.get(1)
        if br.get(1):
            absolute = br.get(1)
            quant = [br.sget(7) if br.get(1) else 0 for _ in range(4)]
            fstrength = [br.sget(6) if br.get(1) else 0 for _ in range(4)]
        if update_map:
            seg_p = [br.get(8) if br.get(1) else 255 for _ in range(3)]
    if br.eof:
        raise fail(-5)
    simple, level, sharp, use_lf = br.get(1), br.get(6), br.get(3), br.get(1)
    ref_lf, mode_lf = [0] * 4, [0] * 4
    if use_lf and br.get(1):
        for i in range(4):
            if br.get(1):
                ref_lf[i] = br.sget(6)
        for i in range(4):
            if br.get(1):
                mode_lf[i] = br.sget(6)
    ftype = 0 if level == 0 else 1 if simple else 2
    if br.eof:
        raise fail(-6)
    nparts = 1 << br.get(2)
    if len(rest) < 3 * (nparts - 1):
        raise fail(-7)
    parts, start = [], 3 * (nparts - 1)
    left = len(rest) - start
    for k in range(nparts - 1):
        psize = min(int.from_bytes(rest[3 * k:3 * k + 3], "little"), left)
        parts.append(_Bool(rest[start:start + psize]))
        start += psize
        left -= psize
    parts.append(_Bool(rest[start:]))
    if start >= len(rest):
        raise fail(-8)
    base_q = br.get(7)
    dq = [br.sget(4) if br.get(1) else 0 for _ in range(5)]
    tab = TABLES.tolist()

    def clip(v, m):
        return 0 if v < 0 else m if v > m else v

    dqm = []
    for i in range(4):
        if not use_segment and i:
            dqm.append(dqm[0])
            continue
        q = (quant[i] + (0 if absolute else base_q)) if use_segment else base_q
        y2ac = max((tab[_ACO + clip(q + dq[2], 127)] * 101581) >> 16, 8)
        dqm.append(((tab[_DCO + clip(q + dq[0], 127)], tab[_ACO + clip(q, 127)]),
                    (tab[_DCO + clip(q + dq[1], 127)] * 2, y2ac),
                    (tab[_DCO + clip(q + dq[3], 117)],
                     tab[_ACO + clip(q + dq[4], 127)])))
    br.get(1)
    flat = [br.get(8) if br.bit(tab[_UPD + i]) else tab[_P0 + i]
            for i in range(1056)]
    probs = [[[flat[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11]
               for c in range(3)] for b in range(8)] for t in range(4)]
    use_skip = br.get(1)
    skip_p = br.get(8) if use_skip else 0
    fstr = {}
    for s in range(4):
        base = (fstrength[s] + (0 if absolute else level)) if use_segment \
            else level
        for i4 in (0, 1):
            lv = base + (ref_lf[0] + (mode_lf[0] if i4 else 0)
                         if use_lf else 0)
            lv = clip(lv, 63)
            il = 0
            if lv > 0:
                il = lv
                if sharp > 0:
                    il >>= 2 if sharp > 4 else 1
                    il = min(il, 9 - sharp)
                il = max(il, 1)
            fstr[s, i4] = (2 * lv + il if lv > 0 else 0, il,
                           (2 if lv >= 40 else 1 if lv >= 15 else 0)
                           if lv > 0 else 0, i4)
    intra_t = [0] * (4 * mb_w)
    top_nz, top_nz_dc = [0] * mb_w, [0] * mb_w
    top_y, top_u, top_v = [0] * (16 * mb_w), [0] * (8 * mb_w), [0] * (8 * mb_w)
    finfo = {}
    w = [0] * (BPS * 26)
    yd = BPS + 8
    ud = yd + BPS * 16 + BPS
    vd = ud + 16
    Y, U, V = yp, up, vp
    for mb_y in range(mb_h):
        intra_l = [0] * 4
        row = []
        for mb_x in range(mb_w):
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            seg = (br.bit(seg_p[1]) if not br.bit(seg_p[0])
                   else br.bit(seg_p[2]) + 2) if update_map else 0
            skip = br.bit(skip_p) if use_skip else 0
            i4 = not br.bit(145)
            if not i4:
                ymode = (1 if br.bit(128) else 3) if br.bit(156) \
                    else (2 if br.bit(163) else 0)
                modes = [ymode]
                top = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        pr = tab[_BM + (top[x] * 10 + ym) * 9:
                                 _BM + (top[x] * 10 + ym) * 9 + 9]
                        i = _YMODES4[br.bit(pr[0])]
                        while i > 0:
                            i = _YMODES4[2 * i + br.bit(pr[i])]
                        ym = -i
                        top[x] = ym
                    modes += top
                    intra_l[y] = ym
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            uvmode = 0 if not br.bit(142) else 2 if not br.bit(114) \
                else 1 if br.bit(183) else 3
            row.append([seg, skip, i4, modes, uvmode, None])
        if br.eof:
            raise fail(-9)
        tb = parts[mb_y & (nparts - 1)]
        left_nz = left_dc = 0
        for mb_x, b in enumerate(row):
            seg, skip, i4, modes, uvmode, _ = b
            co = [0] * 384
            if not skip:
                q = dqm[seg]
                nz_any = False
                if not i4:
                    dc = [0] * 16
                    nz = _coeffs(tb, probs[1], top_nz_dc[mb_x] + left_dc,
                                 q[1], 0, dc, 0)
                    top_nz_dc[mb_x] = left_dc = int(nz > 0)
                    _wht(dc, co)
                    first, ac = 1, probs[0]
                else:
                    first, ac = 0, probs[3]
                tnz, lnz = top_nz[mb_x] & 15, left_nz & 15
                o = 0
                for y in range(4):
                    lf = lnz & 1
                    for x in range(4):
                        nz = _coeffs(tb, ac, lf + (tnz & 1), q[0], first, co, o)
                        lf = int(nz > first)
                        tnz = (tnz >> 1) | (lf << 7)
                        nz_any |= nz > 1 or co[o] != 0
                        o += 16
                    tnz >>= 4
                    lnz = (lnz >> 1) | (lf << 7)
                out_t, out_l = tnz, lnz >> 4
                for ch in (0, 2):
                    tnz, lnz = top_nz[mb_x] >> (4 + ch), left_nz >> (4 + ch)
                    for y in range(2):
                        lf = lnz & 1
                        for x in range(2):
                            nz = _coeffs(tb, probs[2], lf + (tnz & 1), q[2],
                                         0, co, o)
                            lf = int(nz > 0)
                            tnz = (tnz >> 1) | (lf << 3)
                            nz_any |= nz > 1 or co[o] != 0
                            o += 16
                        tnz >>= 2
                        lnz = (lnz >> 1) | (lf << 5)
                    out_t |= (tnz << 4) << ch
                    out_l |= (lnz & 0xF0) << ch
                top_nz[mb_x], left_nz = out_t & 0xFF, out_l & 0xFF
                skip = not nz_any
            else:
                top_nz[mb_x] = left_nz = 0
                if not i4:
                    top_nz_dc[mb_x] = left_dc = 0
            if ftype:
                lim, il, ht, inner = fstr[seg, int(i4)]
                finfo[mb_y, mb_x] = (lim, il, ht, inner or not skip)
            if tb.eof:
                raise fail(-10)
            b[5] = co
        # reconstruction
        for j in range(16):
            w[yd + j * BPS - 1] = 129
        for j in range(8):
            w[ud + j * BPS - 1] = w[vd + j * BPS - 1] = 129
        if mb_y > 0:
            w[yd - 1 - BPS] = w[ud - 1 - BPS] = w[vd - 1 - BPS] = 129
        else:
            w[yd - BPS - 1:yd - BPS + 20] = [127] * 21
            w[ud - BPS - 1:ud - BPS + 8] = [127] * 9
            w[vd - BPS - 1:vd - BPS + 8] = [127] * 9
        for mb_x, (seg, skip, i4, modes, uvmode, co) in enumerate(row):
            if mb_x > 0:
                for j in range(-1, 16):
                    w[yd + j * BPS - 4:yd + j * BPS] = \
                        w[yd + j * BPS + 12:yd + j * BPS + 16]
                for j in range(-1, 8):
                    for d in (ud, vd):
                        w[d + j * BPS - 4:d + j * BPS] = \
                            w[d + j * BPS + 4:d + j * BPS + 8]
            if mb_y > 0:
                w[yd - BPS:yd - BPS + 16] = top_y[16 * mb_x:16 * mb_x + 16]
                w[ud - BPS:ud - BPS + 8] = top_u[8 * mb_x:8 * mb_x + 8]
                w[vd - BPS:vd - BPS + 8] = top_v[8 * mb_x:8 * mb_x + 8]
            if i4:
                tr = yd - BPS + 16
                if mb_y > 0:
                    w[tr:tr + 4] = [top_y[16 * mb_x + 15]] * 4 \
                        if mb_x >= mb_w - 1 \
                        else top_y[16 * mb_x + 16:16 * mb_x + 20]
                for k in (1, 2, 3):
                    w[tr + 4 * k * BPS:tr + 4 * k * BPS + 4] = w[tr:tr + 4]
                for k in range(16):
                    d = yd + (k & 3) * 4 + (k >> 2) * 4 * BPS
                    _pred4(w, d, modes[k])
                    _transform(co, 16 * k, w, d)
            else:
                mode = modes[0]
                if mode == 0:
                    mode = (6 if mb_y == 0 else 5) if mb_x == 0 \
                        else (4 if mb_y == 0 else 0)
                _pred_block(w, yd, mode, 16)
                for k in range(16):
                    _transform(co, 16 * k, w,
                               yd + (k & 3) * 4 + (k >> 2) * 4 * BPS)
            m = uvmode
            if m == 0:
                m = (6 if mb_y == 0 else 5) if mb_x == 0 \
                    else (4 if mb_y == 0 else 0)
            _pred_block(w, ud, m, 8)
            _pred_block(w, vd, m, 8)
            for k in range(4):
                o = (k & 1) * 4 + (k >> 1) * 4 * BPS
                _transform(co, 256 + 16 * k, w, ud + o)
                _transform(co, 320 + 16 * k, w, vd + o)
            if mb_y < mb_h - 1:
                top_y[16 * mb_x:16 * mb_x + 16] = w[yd + 15 * BPS:
                                                    yd + 15 * BPS + 16]
                top_u[8 * mb_x:8 * mb_x + 8] = w[ud + 7 * BPS:ud + 7 * BPS + 8]
                top_v[8 * mb_x:8 * mb_x + 8] = w[vd + 7 * BPS:vd + 7 * BPS + 8]
            for j in range(16):
                Y[16 * mb_y + j, 16 * mb_x:16 * mb_x + 16] = \
                    w[yd + j * BPS:yd + j * BPS + 16]
            for j in range(8):
                U[8 * mb_y + j, 8 * mb_x:8 * mb_x + 8] = \
                    w[ud + j * BPS:ud + j * BPS + 8]
                V[8 * mb_y + j, 8 * mb_x:8 * mb_x + 8] = \
                    w[vd + j * BPS:vd + j * BPS + 8]
    if ftype:
        ys, cs = 16 * mb_w, 8 * mb_w
        fy, fu, fv = (a.reshape(-1).tolist() for a in (Y, U, V))
        for mb_y in range(mb_h):
            for mb_x in range(mb_w):
                lim, il, ht, inner = finfo[mb_y, mb_x]
                if not lim:
                    continue
                py = 16 * mb_y * ys + 16 * mb_x
                pc = 8 * mb_y * cs + 8 * mb_x
                edges = []          # (plane, start, step, along, n, kind, t)
                if mb_x > 0:
                    edges.append((fy, py, 1, ys, 16, 6, lim + 4))
                    edges += [(pl, pc, 1, cs, 8, 6, lim + 4) for pl in (fu, fv)]
                if inner:
                    edges += [(fy, py + 4 * k, 1, ys, 16, 4, lim)
                              for k in (1, 2, 3)]
                    edges += [(pl, pc + 4, 1, cs, 8, 4, lim) for pl in (fu, fv)]
                if mb_y > 0:
                    edges.append((fy, py, ys, 1, 16, 6, lim + 4))
                    edges += [(pl, pc, cs, 1, 8, 6, lim + 4) for pl in (fu, fv)]
                if inner:
                    edges += [(fy, py + 4 * k * ys, ys, 1, 16, 4, lim)
                              for k in (1, 2, 3)]
                    edges += [(pl, pc + 4 * cs, cs, 1, 8, 4, lim)
                              for pl in (fu, fv)]
                for pl, p, step, along, n, kind, t in edges:
                    if ftype == 1:
                        if pl is not fy:
                            continue
                        kind = 0
                    for i in range(n):
                        _filter_edge(pl, p + i * along, step, kind, t, il, ht)
        Y = np.array(fy, np.uint8).reshape(Y.shape)
        U = np.array(fu, np.uint8).reshape(U.shape)
        V = np.array(fv, np.uint8).reshape(V.shape)
    return Y, U, V, width, height
