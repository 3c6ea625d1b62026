"""The GroupNorm kernels' plan (`diffusion_torch.ops.groupnorm.plan`), checked
on the CPU: which path each of the model's slabs takes (one launch through a
thread-block cluster, two launches over row chunks, or the scalar generic
path), the limits every plan keeps to, and a plain-torch emulation of the
plan's partition and Chan merge held to the two-pass statistics."""

import math

import numpy as np
import pytest
import torch

from diffusion_torch.models import layers
from diffusion_torch.models.unet import (SD2_BASE_UNET, UNet2DCondition,
                                         group_norm_shapes)
from diffusion_torch.models.vae import (SD2_VAE, AutoencoderKL,
                                        encoder_group_norm_shapes)
from diffusion_torch.ops import groupnorm as gn

torch.set_num_threads(1)

# (batch, latent side): 256px training microbatch, 512px CFG steps of one
# and two prompts
_UNET_CASES = [(16, 32), (2, 64), (4, 64)]
# the VAE decoder's slabs at 512px that no cluster holds (one image)
_VAE_SLABS = [(1, 262144, 128), (1, 262144, 256), (1, 65536, 256),
              (1, 65536, 512)]


def _assert_valid(p: gn.Plan, b, l, c, groups, itemsize):
    cg = c // groups
    assert p.smem <= 232448
    assert p.width % cg == 0 and c % p.width == 0            # whole groups
    assert p.groups_per_slice == p.width // cg
    if p.vec > 1:
        assert p.vec == 16 // itemsize
        assert (p.width * itemsize) % 16 == 0                # 16-byte slices
    if not p.split:
        assert 1 <= p.parts <= gn.MAX_CLUSTER_NONPORTABLE
    assert p.rows * p.parts >= l and (p.parts - 1) * p.rows < l
    assert p.threads % 32 == 0 and p.width // p.vec <= p.threads <= 512


def test_unet_shapes_match_a_forward(monkeypatch):
    """`group_norm_shapes` lists the slabs a full-width UNet forward hands
    the op, in call order (recorded on the meta device)."""
    calls = []

    def record(x, scale, bias, groups, eps, act):
        calls.append((tuple(x.shape[:1]) + (x.shape[1] * x.shape[2],
                                            x.shape[3]), groups, act))
        return x

    monkeypatch.setattr(layers, "group_norm", record)
    with torch.device("meta"):
        unet = UNet2DCondition()
        for batch, side in _UNET_CASES:
            calls.clear()
            lat = torch.empty((batch, 4, side, side)).contiguous(
                memory_format=torch.channels_last)
            unet(lat, torch.zeros(batch, dtype=torch.long),
                 torch.empty((batch, 77, 1024)))
            want = group_norm_shapes(SD2_BASE_UNET, batch, side)
            assert len(want) == 61
            assert calls == want


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("batch,side", _UNET_CASES)
def test_unet_shapes_take_one_launch(batch, side, backward):
    for (b, l, c), groups, _ in group_norm_shapes(SD2_BASE_UNET, batch, side):
        p = gn.plan(b, l, c, groups, 2, backward)
        _assert_valid(p, b, l, c, groups, 2)
        assert p.path == "cluster" and p.launches == 1, ((b, l, c), p)
        assert p.tiles == (2 if backward else 1)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("shape", _VAE_SLABS)
def test_vae_decoder_slabs_split(shape, backward):
    p = gn.plan(*shape, 32, 2, backward)
    _assert_valid(p, *shape, 32, 2)
    assert p.path == "split" and p.launches == 2
    # 128-byte rows of whole groups, chunks of at most 64 KB of tiles
    assert p.width * 2 >= 128
    assert p.tiles * p.rows * p.width * 2 <= 64 * 1024
    assert p.scratch(shape[0], shape[2], 32) > 0


@pytest.mark.parametrize("batch,height,width", [(16, 256, 256),
                                                 (2, 512, 512),
                                                 (1, 64, 64), (1, 40, 72)])
def test_vae_encoder_shapes_are_planned(monkeypatch, batch, height, width):
    """`encoder_group_norm_shapes` lists the slabs a full-width VAE encode
    hands the op (22 calls, recorded on the meta device); each has a valid
    plan: one launch through a cluster, or two where no cluster holds an
    image's slice (the slabs of 65,536 rows and more)."""
    calls = []

    def record(x, scale, bias, groups, eps, act):
        calls.append((tuple(x.shape[:1]) + (x.shape[1] * x.shape[2],
                                            x.shape[3]), groups, act))
        return x

    monkeypatch.setattr(layers, "group_norm", record)
    with torch.device("meta"):
        vae = AutoencoderKL(SD2_VAE)
        vae.encode(torch.empty((batch, 3, height, width)))
    want = encoder_group_norm_shapes(SD2_VAE, batch, height, width)
    assert len(want) == 22 and calls == want
    for backward in (False, True):
        for (b, l, c), groups, _ in want:
            p = gn.plan(b, l, c, groups, 2, backward)
            _assert_valid(p, b, l, c, groups, 2)
            assert p.launches == (2 if p.path == "split" else 1)
            assert p.path == ("split" if l >= 65536 else "cluster"), (
                (b, l, c), p)


@pytest.mark.parametrize("shape,groups,itemsize,aligned,path", [
    ((2, 50, 36), 4, 2, True, "generic"),      # C * 2 % 16 != 0
    ((2, 50, 36), 4, 4, True, "cluster"),      # fp32: 144-byte rows
    ((2, 50, 18), 6, 4, True, "generic"),      # fp32: C * 4 % 16 != 0
    ((3, 777, 96), 32, 2, True, "cluster"),    # C/G = 3: 24-channel slices
    ((3, 777, 96), 32, 4, True, "cluster"),    # fp32: 12-channel slices
    ((2, 1024, 320), 32, 2, False, "generic"),  # a misaligned pointer
])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_generic_and_odd_groups(shape, groups, itemsize, aligned, path,
                                backward):
    p = gn.plan(*shape, groups, itemsize, backward, aligned)
    _assert_valid(p, *shape, groups, itemsize)
    assert p.path == path
    if path == "generic":
        assert p.vec == 1
    if shape[-1] // groups == 3 and p.vec > 1:
        # whole groups that are also whole 16-byte vectors
        assert p.width % math.lcm(3, p.vec) == 0


def test_cluster_size_boundary():
    """The 512px backward of the up-block concat (C = 960) needs a
    non-portable cluster: a slice of 120 channels over 4096 rows is 1.97 MB
    of x and g, more than 8 blocks' shared memory."""
    p = gn.plan(4, 4096, 960, 32, 2, True)
    _assert_valid(p, 4, 4096, 960, 32, 2)
    assert p.path == "cluster" and p.parts > gn.MAX_CLUSTER
    assert 2 * 4096 * 120 * 2 > gn.MAX_CLUSTER * gn.SMEM_PER_BLOCK
    q = gn.plan(4, 4096, 960, 32, 2, False)
    assert q.path == "cluster" and q.parts <= gn.MAX_CLUSTER


def _emulated_stats(x: torch.Tensor, groups: int, p: gn.Plan, eps: float):
    """The kernels' statistics in plain torch, fp32: per block (slice,
    rows) and group, the two-pass (n, mean, M2) of its tile, then Chan's
    merge over the image's blocks in block order."""
    b, l, c = x.shape
    cg = c // groups
    n = torch.zeros(b, groups)
    mean = torch.zeros(b, groups)
    m2 = torch.zeros(b, groups)
    for k in range(p.parts):
        tile = x[:, k * p.rows:(k + 1) * p.rows].reshape(b, -1, groups, cg)
        nb = tile.shape[1] * cg
        if nb == 0:
            continue
        mb = tile.sum(dim=(1, 3)) / nb
        m2b = (tile - mb[:, None, :, None]).square().sum(dim=(1, 3))
        nn = n + nb
        d = mb - mean
        mean = mean + d * (nb / nn)
        m2 = m2 + m2b + d * d * n * (nb / nn)
        n = nn
    return mean, torch.rsqrt(m2 / n + eps)


@pytest.mark.parametrize("shape,groups,backward", [
    ((2, 4096, 320), 32, False),     # one launch, a cluster of 8
    ((3, 777, 96), 32, False),       # ragged last block, C/G = 3
    ((1, 65536, 256), 32, False),    # two launches, 128 chunks
])
def test_emulated_partition_matches_two_pass_at_large_mean(shape, groups,
                                                           backward):
    """The plan's partition and Chan merge keep large-mean inputs exact
    (mean 1000, unit variance), where E[x^2] - E[x]^2 cancels."""
    p = gn.plan(*shape, groups, 2, backward)
    assert p.parts > 1
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.standard_normal(shape) + 1000.0).astype(
        np.float32))
    mean, rstd = _emulated_stats(x, groups, p, 1e-5)
    want_mean, want_rstd = gn.group_norm_stats_reference(x, groups, 1e-5)
    # the GPU tests' statistics tolerances
    torch.testing.assert_close(mean, want_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, want_rstd, atol=1e-5, rtol=1e-4)
    xg = x.reshape(shape[0], -1, groups, shape[-1] // groups)
    one_pass = xg.square().mean(dim=(1, 3)) - xg.mean(dim=(1, 3)).square()
    assert ((torch.rsqrt(one_pass.clamp_min(0) + 1e-5) - want_rstd).abs()
            / want_rstd).max() > 1e-2          # the one-pass form cancels
