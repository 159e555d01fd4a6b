"""The FLOP and byte counters against hand counts, and the layer layout
against the program's module."""

import pytest
import torch

from ocm_bench import data, flops, run

SMALL = dict(input_length=20, latent_dim=3, conv_blocks=2, n_filters=4,
             kernel_size=3, stride=2, hidden_fc=5, activation="elu")


@pytest.mark.parametrize("cfg", [
    run.load_json(run.HERE / "configs" / "nuts_swir.json"), SMALL],
    ids=["nuts_swir", "small"])
def test_layers_match_the_programs_state_dict(cfg):
    from ocm_tpu_torch.models.vae import ConvVAE1D

    model = ConvVAE1D(cfg["input_length"], cfg["latent_dim"],
                      conv_blocks=cfg["conv_blocks"],
                      n_filters=cfg["n_filters"],
                      kernel_size=cfg["kernel_size"],
                      stride=cfg["stride"], hidden_fc=cfg["hidden_fc"])
    ours = {k: tuple(s) for k, s, _, _ in data.leaves(cfg)}
    theirs = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == theirs


def test_flops_by_hand_small():
    # encoder: conv 1->4 k3 on 20 (stride 1, out 20), conv 4->8 k3 stride 2
    # (out 10), dense 80->5, mu and logvar 5->3
    enc = 2 * 4 * 1 * 3 * 20 + 2 * 8 * 4 * 3 * 10 + 2 * 80 * 5 + 2 * 2 * 5 * 3
    # decoder: dense 3->5, 5->80, convt 8->4 k3 stride 2 on 10 (out 20),
    # convt 4->4 k3 stride 1 on 20, conv 4->1 k1 on 20
    dec = (2 * 3 * 5 + 2 * 5 * 80 + 2 * 8 * 4 * 3 * 10 + 2 * 4 * 4 * 3 * 20
           + 2 * 4 * 20)
    assert flops.encode_flops(SMALL) == enc
    assert flops.decode_flops(SMALL) == dec
    maha = 2 * 9 + 9
    assert flops.screen_flops(SMALL, "d2") == enc + maha
    assert flops.screen_flops(SMALL, "vaesimca") == 2 * enc + dec + maha + 9


def test_flops_at_the_config():
    cfg = run.load_json(run.HERE / "configs" / "nuts_swir.json")
    # conv 1->32 k9 on 288, 32->64 stride 2 (out 144), 64->128 (out 72),
    # dense 9,216->128, mu and logvar 128->16
    enc = (2 * 32 * 9 * 288 + 2 * 64 * 32 * 9 * 144 + 2 * 128 * 64 * 9 * 72
           + 2 * 9216 * 128 + 2 * 2 * 128 * 16)
    # dense 16->128, 128->9,216, convt 128->64 k9 stride 2 on 72 (out 144),
    # 64->32 stride 2 on 144 (out 288), 32->32 stride 1 on 288, conv 32->1
    # k1 on 288
    dec = (2 * 16 * 128 + 2 * 128 * 9216 + 2 * 128 * 64 * 9 * 72
           + 2 * 64 * 32 * 9 * 144 + 2 * 32 * 32 * 9 * 288 + 2 * 32 * 288)
    assert flops.encode_flops(cfg) == enc
    assert flops.decode_flops(cfg) == dec


def test_weights_follow_the_seed():
    cfg = dict(SMALL)
    a = data.vae_weights(cfg, 2 ** 33 + 1, (data.WEIGHTS,))
    b = data.vae_weights(cfg, 2 ** 33 + 1, (data.WEIGHTS,))
    c = data.vae_weights(cfg, 2 ** 33 + 2, (data.WEIGHTS,))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc.0.weight"], c["fc.0.weight"])
