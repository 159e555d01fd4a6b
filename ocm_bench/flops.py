"""Operations and bytes of the work a cell does, from the layer shapes
(``data.layers``), and the table of the card's peaks.

FLOPs count the multiply-adds of convolutions, transposed convolutions
and dense layers as two operations each; elementwise work (bias,
BatchNorm, ELU, standardization) is left out, so a share of the peak
computed from these is a lower bound of the share the card achieves.
"""

from __future__ import annotations

from ocm_bench import data

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12        # bytes/s


def layer_flops(lay: dict) -> int:
    """Forward FLOPs of one layer for one spectrum."""
    if lay["kind"] == "conv":
        return 2 * lay["cout"] * lay["cin"] * lay["k"] * lay["lout"]
    if lay["kind"] == "convt":
        return 2 * lay["cin"] * lay["cout"] * lay["k"] * lay["lin"]
    if lay["kind"] == "dense":
        return 2 * lay["cin"] * lay["cout"]
    return 0


def encode_flops(cfg: dict) -> int:
    return sum(layer_flops(lay) for lay in data.layers(cfg)
               if lay["part"] == "enc")


def decode_flops(cfg: dict) -> int:
    return sum(layer_flops(lay) for lay in data.layers(cfg)
               if lay["part"] == "dec")


def mahalanobis_flops(k: int) -> int:
    """(mu - m) @ inv, times (mu - m), summed."""
    return 2 * k * k + 3 * k


def screen_flops(cfg: dict, variant: str) -> int:
    """FLOPs a screened spectrum costs one class: the encoder pass and the
    latent distance; VAE-SIMCA adds the decoder and a second encoder pass
    (the latent round trip) and its residual."""
    k = cfg["latent_dim"]
    if variant == "d2":
        return encode_flops(cfg) + mahalanobis_flops(k)
    if variant == "vaesimca":
        return (2 * encode_flops(cfg) + decode_flops(cfg)
                + mahalanobis_flops(k) + 3 * k)
    raise ValueError(f"no FLOP count for variant {variant!r}")
