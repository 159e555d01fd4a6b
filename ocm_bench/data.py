"""Inputs and weights of a run, made from its seed.

Everything here is the benchmark's own: the program under test receives
what these functions make, and the reference (``reference.py``) makes the
same again from the same seed.  Spectra and weights are drawn on the
run's device by ``torch.Generator``s in a few large calls.

Seeds: ``sub_seed(seed, *path)`` is numpy's ``SeedSequence(seed)`` child
at ``path``, a 63-bit integer, so any whole ``--seed`` (also above 2**32)
gives independent, fixed streams for weights, calibration sets, frames
and their order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# stream names -> spawn keys of ``sub_seed``
WEIGHTS, CALIBRATION, FRAMES, ORDER = range(4)


def sub_seed(seed: int, *path: int) -> int:
    ss = np.random.SeedSequence(int(seed), spawn_key=tuple(int(p) for p in path))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *path: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *path))


# ---------------------------------------------------------------------------
# ConvVAE1D's state-dict layout (the reference checkpoint's keys)
# ---------------------------------------------------------------------------


def conv_out_length(length: int, k: int, stride: int) -> int:
    pad = k // 2
    return (length + 2 * pad - (k - 1) - 1) // stride + 1


def convt_out_length(length: int, k: int, stride: int) -> int:
    pad = k // 2
    return (length - 1) * stride - 2 * pad + (k - 1) + (stride - 1) + 1


def layers(cfg: dict) -> list[dict]:
    """The network's layers in order, with their shapes per spectrum:
    ``kind`` (conv, bn, dense, convt), ``key`` (state-dict prefix),
    channels ``cin``/``cout`` (features for dense), kernel ``k``, stride,
    lengths ``lin``/``lout`` and ``part`` (enc, dec)."""
    length, k, s = cfg["input_length"], cfg["kernel_size"], cfg["stride"]
    nf, blocks = cfg["n_filters"], cfg["conv_blocks"]
    hidden, latent = cfg["hidden_fc"], cfg["latent_dim"]
    out, step = [], 3            # conv, BatchNorm, Identity per block
    cin, cout, lin = 1, nf, length
    for b in range(blocks):
        stride = 1 if b == 0 else s
        lout = conv_out_length(lin, k, stride)
        out.append(dict(kind="conv", key=f"encoder_conv.{b * step}", cin=cin,
                        cout=cout, k=k, stride=stride, lin=lin, lout=lout,
                        part="enc"))
        out.append(dict(kind="bn", key=f"encoder_conv.{b * step + 1}",
                        cin=cout, cout=cout, lin=lout, lout=lout, part="enc"))
        cin, cout, lin = cout, min(cout * 2, 1024), lout
    enc_ch, enc_len = cin, lin
    fc_in = enc_ch * enc_len
    out.append(dict(kind="dense", key="fc.0", cin=fc_in, cout=hidden,
                    part="enc"))
    out.append(dict(kind="dense", key="fc_mu", cin=hidden, cout=latent,
                    part="enc"))
    out.append(dict(kind="dense", key="fc_logvar", cin=hidden, cout=latent,
                    part="enc"))
    out.append(dict(kind="dense", key="fc_dec.0", cin=latent, cout=hidden,
                    part="dec"))
    out.append(dict(kind="dense", key="fc_dec.3", cin=hidden, cout=fc_in,
                    part="dec"))
    ch, lin = enc_ch, enc_len
    for b in range(blocks):
        nxt = max(ch // 2, nf)
        stride = s if b < blocks - 1 else 1
        lout = convt_out_length(lin, k, stride)
        out.append(dict(kind="convt", key=f"decoder_conv.{b * step}", cin=ch,
                        cout=nxt, k=k, stride=stride, lin=lin, lout=lout,
                        part="dec"))
        out.append(dict(kind="bn", key=f"decoder_conv.{b * step + 1}",
                        cin=nxt, cout=nxt, lin=lout, lout=lout, part="dec"))
        ch, lin = nxt, lout
    out.append(dict(kind="conv", key=f"decoder_conv.{blocks * step}", cin=ch,
                    cout=1, k=1, stride=1, lin=lin, lout=lin, part="dec"))
    return out


def encoder_shape(cfg: dict) -> tuple[int, int]:
    enc = [lay for lay in layers(cfg) if lay["kind"] == "conv"
           and lay["part"] == "enc"]
    return enc[-1]["cout"], enc[-1]["lout"]


def leaves(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(key, shape, role, scale) of every state-dict entry: role ``w``
    (normal, std ``scale`` = 1/sqrt(fan in)), ``b`` (normal bias),
    ``g``/``beta``/``rm``/``rv`` (BatchNorm weight, bias, running mean and
    variance) and ``nbt`` (the batch counter)."""
    out = []
    for lay in layers(cfg):
        key = lay["key"]
        if lay["kind"] == "bn":
            c = (lay["cout"],)
            out += [(f"{key}.weight", c, "g", 0.1), (f"{key}.bias", c, "beta", 0.1),
                    (f"{key}.running_mean", c, "rm", 0.1),
                    (f"{key}.running_var", c, "rv", 0.2),
                    (f"{key}.num_batches_tracked", (), "nbt", 0.0)]
            continue
        if lay["kind"] == "dense":
            shape, fan = (lay["cout"], lay["cin"]), lay["cin"]
        elif lay["kind"] == "conv":
            shape, fan = (lay["cout"], lay["cin"], lay["k"]), lay["cin"] * lay["k"]
        else:                   # transposed conv: weight (in, out, k)
            shape, fan = (lay["cin"], lay["cout"], lay["k"]), lay["cout"] * lay["k"]
        out += [(f"{key}.weight", shape, "w", 1.0 / math.sqrt(fan)),
                (f"{key}.bias", (lay["cout"],), "b", 0.05)]
    return out


def vae_weights(cfg: dict, seed: int, path: tuple, device="cpu") -> dict:
    """A ConvVAE1D state dict drawn from the seed on ``device`` in one
    normal draw: Kaiming-normal weights, N(0, 0.05^2) biases, BatchNorm
    weights 1 + N(0, 0.1^2), biases and running means N(0, 0.1^2), running
    variances exp(N(0, 0.2^2)), as a trained model's stand-in."""
    spec = leaves(cfg)
    sizes = [math.prod(shape) for _, shape, role, _ in spec if role != "nbt"]
    z = torch.randn(sum(sizes), generator=generator(seed, *path,
                                                    device=device),
                    device=device, dtype=torch.float32)
    state, at = {}, 0
    for key, shape, role, scale in spec:
        if role == "nbt":
            state[key] = torch.zeros((), dtype=torch.long, device=device)
            continue
        size = math.prod(shape)
        v = z[at:at + size].view(shape)
        at += size
        if role == "g":
            v = 1.0 + scale * v
        elif role == "rv":
            v = torch.exp(scale * v)
        else:
            v = scale * v
        state[key] = v.contiguous()
    return state


# ---------------------------------------------------------------------------
# spectra
# ---------------------------------------------------------------------------


def nut_bases(classes, length: int, device) -> torch.Tensor:
    """(C, L) base spectra of the nut classes (utils/synthetic.py's)."""
    t = torch.linspace(0.0, 1.0, length, dtype=torch.float64, device=device)
    rows = [torch.sin(2 * math.pi * (2 + 0.5 * i) * t) + 1.5 + 0.3 * i
            for i in range(len(classes))]
    return torch.stack(rows).float()


def nut_pixels(cfg: dict, shares: dict, n: int, gen: torch.Generator,
               device) -> torch.Tensor:
    """(n, L) float32 pixel spectra: each pixel background (N(0.02, 0.01)
    per band) or a nut of one class (amplitude N(1, 0.05) times the class
    base, plus N(0, 0.02) per band), drawn with the probabilities
    ``shares`` (class name or 'background' -> share)."""
    length, classes = cfg["input_length"], cfg["classes"]
    names = ["background"] + list(classes)
    p = torch.tensor([float(shares.get(c, 0.0)) for c in names],
                     dtype=torch.float64)
    cum = torch.cumsum(p / p.sum(), 0)[:-1].float().to(device)
    u = torch.rand(n, generator=gen, device=device)
    cls = torch.bucketize(u, cum, right=True)           # 0 = background
    base = torch.cat([torch.full((1, length), 0.02, device=device),
                      nut_bases(classes, length, device)])
    noise_sd = torch.tensor([0.01] + [0.02] * len(classes), device=device)
    amp = 1.0 + 0.05 * torch.randn(n, generator=gen, device=device)
    amp = torch.where(cls == 0, 1.0, amp)
    noise = torch.randn((n, length), generator=gen, device=device)
    return amp[:, None] * base[cls] + noise_sd[cls][:, None] * noise


def calibration_set(cfg: dict, seed: int, cls: int, device) -> torch.Tensor:
    """The calibration spectra of nut class ``cls`` (index into
    ``cfg['classes']``), on ``device``."""
    shares = {cfg["classes"][cls]: 1.0}
    return nut_pixels(cfg, shares, cfg["calibration_spectra"],
                      generator(seed, CALIBRATION, cls, device=device),
                      device)


def frame_pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``pool_frames`` camera frames as host float32 numpy arrays
    (frame_spectra, L), as the camera hands them to the scorer."""
    gen = generator(seed, FRAMES, device=device)
    n, m = cfg["frame_spectra"], traffic["pool_frames"]
    x = nut_pixels(cfg, traffic["class_shares"], n * m, gen, device)
    host = x.cpu().numpy()
    return [host[i * n:(i + 1) * n] for i in range(m)]


def frame_order(seed: int, pool: int, count: int) -> np.ndarray:
    """The pool index of each frame sent: whole seed-drawn permutations of
    the pool, so every seed sends the same frames, in another order."""
    rng = np.random.default_rng(sub_seed(seed, ORDER))
    reps = -(-count // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(reps)])[:count]
