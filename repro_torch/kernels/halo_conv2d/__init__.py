"""Halo-partitioned block of fused 3x3 convolutions with leaky-ReLU (the
paper's section 3.2 YoloV2 conv blocks): CUDA kernel, wrapper, plain
version."""
from .ops import halo_conv_block, halo_conv_block_ref, halo_conv_block_tiles
from .ref import conv_block_ref, halo_conv_block_tiles_ref, maxpool2x2_ref

__all__ = ["conv_block_ref", "halo_conv_block", "halo_conv_block_ref",
           "halo_conv_block_tiles", "halo_conv_block_tiles_ref",
           "maxpool2x2_ref"]
