"""The inputs repeat from a seed, differ between seeds and steps, and take
seeds beyond 32 bits."""

import torch

from portbench.kinds.train import Feed, draws
from portbench.reference.unet import UNet2DCondition, unet_spec
from portbench.tests.tiny import TINY_UNET, tiny_files
from portbench.weights import derive_seed, draw_like

BIG = 2 ** 31 + 12345


def test_derive_seed_repeats_and_separates():
    assert derive_seed(BIG, "data", 3) == derive_seed(BIG, "data", 3)
    seeds = {derive_seed(s, "data", k) for s in (BIG, BIG + 1, 7)
             for k in range(4)}
    assert len(seeds) == 12
    assert derive_seed(2 ** 40, "x") != derive_seed(2 ** 40 + 2 ** 32, "x")
    assert 0 <= derive_seed(2 ** 62 + 5, "unet") < 2 ** 63


def test_batches_and_draws_repeat_from_the_seed():
    f = tiny_files()
    a = Feed(BIG, f["traffic"], f["config"], torch.device("cpu"))
    b = Feed(BIG, f["traffic"], f["config"], torch.device("cpu"))
    first = [next(iter(a)) for _ in range(3)]
    again = [next(iter(b)) for _ in range(3)]
    for x, y in zip(first, again):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(first[0]["image_latents"],
                           first[1]["image_latents"])
    other = Feed(BIG + 1, f["traffic"], f["config"], torch.device("cpu"))
    assert not torch.equal(other.batch(0)["image_latents"],
                           first[0]["image_latents"])
    lat = first[0]["image_latents"]
    n1, t1 = draws(BIG, 2, 1, lat, 1000)
    n2, t2 = draws(BIG, 2, 1, lat, 1000)
    assert torch.equal(n1, n2) and torch.equal(t1, t2)
    assert n1.shape == lat.shape and t1.shape == (lat.shape[0],)
    assert not torch.equal(draws(BIG, 2, 0, lat, 1000)[0], n1)


def test_weights_repeat_and_have_their_scales():
    with torch.device("meta"):
        unet = UNet2DCondition(unet_spec(TINY_UNET))
    _, a = draw_like(unet, derive_seed(BIG, "unet"), "cpu")
    _, b = draw_like(unet, derive_seed(BIG, "unet"), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert list(a) == [n for n, _ in unet.named_parameters()]
    w = a["conv_in.weight"]
    assert abs(w.std().item() * (4 * 9) ** 0.5 - 1.0) < 0.2
    norm = a["conv_norm_out.weight"]
    assert abs(norm.mean().item() - 1.0) < 0.05
