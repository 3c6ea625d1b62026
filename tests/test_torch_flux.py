"""FLUX.1's transformer (`diffusion_torch/models/flux.py`) and its
rectified-flow training (`schedulers/flow_match.py`'s dynamic shift,
`models/stable_diffusion_3.py`) against the plain reference
(`portbench/reference/flux.py`), on the CPU in fp32 with seeded weights, at
a small size: 1 double-stream and 2 single-stream blocks, 2 heads of 16
with rotary axes (4, 6, 6), 8x8 latents (16 packed tokens) and 7 text
tokens. Also the published config's parameters and state_dict on the meta
device, the rotation, the packing, the shift, SD3's draws, the working
copies and the Trainer.

    python -m pytest tests/test_torch_flux.py -q -p no:randomly
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from diffusion_torch.models import flux as fx
from diffusion_torch.models.models import flux, stable_diffusion_3
from diffusion_torch.models.stable_diffusion_3 import POOLED
from diffusion_torch.ops import working_copy as wc
from diffusion_torch.schedulers import flow_match
from diffusion_torch.train.optim import adamw
from diffusion_torch.train.trainer import Trainer
from portbench.reference import flux as ref
from portbench.reference import mmdit as ref_mmdit

torch.set_num_threads(1)

_TINY = {"_class_name": "FluxTransformer2DModel", "patch_size": 1,
         "in_channels": 16, "num_layers": 1, "num_single_layers": 2,
         "attention_head_dim": 16, "num_attention_heads": 2,
         "joint_attention_dim": 24, "pooled_projection_dim": 20,
         "guidance_embeds": True, "axes_dims_rope": [4, 6, 6]}
_TOKENS = 7


def _pair(seed=0):
    """(program model, reference) in fp32 with the reference's seeded
    weights, moved off their initial values (adaLN's zero modulation, the
    norms' unit scales)."""
    torch.manual_seed(seed)
    reference = ref.Flux(ref.flux_spec(_TINY))
    with torch.no_grad():
        for p in reference.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model = flux(_TINY, encode_latents_in_fp16=False, device="cpu")
    model.unet.load_state_dict(reference.state_dict())
    return model, reference


def _batch(n=3, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return {"image_latents": torch.randn((n, 8, 8, 4), generator=gen),
            "caption_latents": torch.randn((n, _TOKENS, 24), generator=gen),
            POOLED: torch.randn((n, 20), generator=gen)}


def _draws(n=3, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((n, 8, 8, 4), generator=gen),
            flow_match.sample_timesteps(n, gen, shift=math.exp(0.5)))


# fp32 on both sides; the program's RMSNorm-rotate chain, its
# LayerNorm-modulate and gated residuals (addcmul) and its attention (fp32
# scores, lse softmax) round in another order than the reference's complex
# rotation and plain ops: a few ulps an op over 3 blocks
_TOL = dict(atol=1e-5, rtol=1e-4)


def test_forward_matches_reference():
    model, reference = _pair()
    b = _batch()
    _, t = _draws()
    x = b["image_latents"].permute(0, 3, 1, 2)
    g = torch.full_like(t, 3500.0)
    got = model.unet(x, t * 1000, b["caption_latents"], b[POOLED], g)
    want = reference(x, t * 1000, b["caption_latents"], b[POOLED])
    assert got.dtype == torch.float32 and got.shape == (3, 4, 8, 8)
    torch.testing.assert_close(got, want, **_TOL)


def test_flow_loss_matches_reference():
    model, reference = _pair()
    b = _batch()
    noise, t = _draws()
    got = model.loss_fn(b, None, noise, t)
    want = ref_mmdit.flow_loss(reference, b, noise, t)
    # one loss over 3 x 256 values, summed in another order
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    _, target, t_out = model.forward(b, None, noise, t)
    torch.testing.assert_close(target, noise - b["image_latents"])
    assert torch.equal(t_out, t)


def test_every_gradient_matches_reference():
    model, reference = _pair()
    b = _batch()
    noise, t = _draws()
    model.loss_fn(b, None, noise, t).backward()
    ref_mmdit.flow_loss(reference, b, noise, t).backward()
    want = dict(reference.named_parameters())
    got = dict(model.unet.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        w = want[name].grad
        # gradients are sums over the batch and tokens: the absolute
        # tolerance scales with the leaf's largest entry
        torch.testing.assert_close(
            p.grad, w, rtol=1e-4, atol=1e-5 * max(1.0, float(w.abs().max())),
            msg=name)
    # the q/k norms' scales learn, in both streams
    for name in ("transformer_blocks.0.attn.norm_added_k.weight",
                 "single_transformer_blocks.1.attn.norm_q.weight"):
        assert got[name].grad.abs().max() > 0


def test_state_dict_at_the_published_config():
    with torch.device("meta"):
        reference = ref.Flux(ref.flux_spec(dict(
            dataclasses.asdict(fx.FLUX_DEV), _class_name="x")))
    model = flux(device="meta")
    got = {k: tuple(v.shape) for k, v in model.unet.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in reference.state_dict().items()}
    assert got == want
    # diffusers' FluxTransformer2DModel names
    assert got["x_embedder.weight"] == (3072, 64)
    assert got["context_embedder.weight"] == (3072, 4096)
    for emb, width in (("timestep_embedder", 256), ("guidance_embedder", 256),
                       ("text_embedder", 768)):
        assert got[f"time_text_embed.{emb}.linear_1.weight"] == (3072, width)
    assert got["transformer_blocks.18.norm1.linear.weight"] == (18432, 3072)
    assert got["transformer_blocks.0.attn.norm_added_q.weight"] == (128,)
    assert got["transformer_blocks.0.attn.to_add_out.weight"] == (3072, 3072)
    assert got["single_transformer_blocks.37.norm.linear.weight"] == (
        9216, 3072)
    assert got["single_transformer_blocks.0.proj_out.weight"] == (3072,
                                                                  15360)
    assert got["single_transformer_blocks.0.attn.norm_k.weight"] == (128,)
    for gone in ("attn.to_out.0.weight", "attn.add_q_proj.weight"):
        assert "single_transformer_blocks.0." + gone not in got
    assert got["norm_out.linear.weight"] == (6144, 3072)
    assert got["proj_out.weight"] == (64, 3072)
    assert not any(k.startswith("transformer_blocks.19.") for k in got)


@pytest.mark.parametrize("double,single,want", [
    (19, 38, 11_901_408_320),     # published
    (4, 8, 2_556_184_640),        # the benchmark's cut
])
def test_parameter_count(double, single, want):
    model = flux(dict(num_layers=double, num_single_layers=single),
                 device="meta")
    assert sum(p.numel() for p in model.unet.parameters()) == want


def test_builder_refuses_unknown_keys():
    with pytest.raises(ValueError, match="not supported"):
        flux({"num_layers": 1, "qk_norm": "rms"}, device="meta")


def test_pairwise_rotation_equals_the_complex_form():
    spec = ref.flux_spec(dict(dataclasses.asdict(fx.FLUX_DEV)))
    cos, sin = fx.rope_table(fx.image_ids(5, 7, 3), fx.FLUX_DEV.axes_dims_rope)
    cis = ref.freqs_cis(spec, 3, 5, 7, "cpu")
    torch.testing.assert_close(cos, cis.real, atol=0, rtol=0)
    torch.testing.assert_close(sin, cis.imag, atol=0, rtol=0)
    x = torch.randn(2, 38, 4, 128, generator=torch.Generator().manual_seed(3))
    got = fx.rotate(x, cos[:, None], sin[:, None])
    want = ref._rope(x.transpose(1, 2), cis).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    # text tokens and the first axis do not turn
    assert torch.equal(cos[:3], torch.ones_like(cos[:3]))
    assert torch.equal(cos[:, :8], torch.ones_like(cos[:, :8]))
    # image token (r, c): axis 1 turns by r, axis 2 by c, at frequency 1
    r, c = 4, 6
    assert cos[3 + r * 7 + c, 8].item() == pytest.approx(math.cos(r))
    assert sin[3 + r * 7 + c, 36].item() == pytest.approx(math.sin(c))


def test_packing_inverts():
    x = torch.randn(2, 16, 6, 10)
    tokens = fx.pack(x)
    assert tokens.shape == (2, 15, 64)
    assert torch.equal(fx.unpack(tokens, 6, 10), x)
    # channel c of patch offset (dy, dx) at 4c + 2dy + dx, row by row
    assert tokens[1, 5 + 2, 4 * 3 + 2 + 1] == x[1, 3, 2 * 1 + 1, 2 * 2 + 1]


def test_dynamic_shift_is_the_published_line():
    assert flow_match.dynamic_mu(4096) == pytest.approx(1.15)
    assert flow_match.dynamic_mu(256) == pytest.approx(0.5)
    assert flow_match.dynamic_shift(4096) == pytest.approx(3.158192909689767)
    # the model's own draws shift at its latents' packed length
    model = flux(_TINY, encode_latents_in_fp16=False, device="cpu")
    assert model.timestep_shift((2, 8, 8, 4)) == math.exp(
        flow_match.dynamic_mu(16))
    t, noise = model.training_draws(
        (2, 128, 128, 16), torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    u = torch.sigmoid(torch.randn((2,), generator=gen))
    s = flow_match.dynamic_shift(4096)
    torch.testing.assert_close(t, s * u / (1 + (s - 1) * u))


def test_sd3_draws_are_unchanged():
    """SD3's t: the shift of 3.0 in the same expression, bit for bit."""
    model = stable_diffusion_3({"num_layers": 1, "sample_size": 8,
                                "pos_embed_max_size": 8}, device="meta")
    assert model.shift == flow_match.SHIFT and model.guidance is None
    gen = torch.Generator().manual_seed(9)
    got = flow_match.sample_timesteps(64, gen)
    gen = torch.Generator().manual_seed(9)
    u = torch.sigmoid(torch.randn((64,), generator=gen,
                                  dtype=torch.float32))
    assert torch.equal(got, 3.0 * u / (1.0 + (3.0 - 1.0) * u))


def test_working_copies_cover_every_weight():
    """In bf16 the step's working copies hold every trained weight, the
    q/k norms' scales too: one accumulation a parameter, no fallback."""
    model = flux(_TINY, device="cpu")
    n = sum(1 for _ in model.unet.parameters())
    covered = {id(p) for pair in wc._covered(model.unet) for p in pair
               if p is not None}
    assert len(covered) == n
    before = (wc.accumulations.value, wc.fallbacks.value)
    noise, t = _draws(2)
    b = {k: v[:2] for k, v in _batch().items()}
    with wc.working_copies(model.unet):
        model.loss_fn(b, None, noise, t).backward()
    assert (wc.accumulations.value - before[0],
            wc.fallbacks.value - before[1]) == (n, 0)


def test_trainer_fits_the_tiny_model():
    model = flux(_TINY, encode_latents_in_fp16=False, device="cpu")
    start = {k: v.clone() for k, v in model.unet.state_dict().items()}
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in _batch(4).items()} for _ in range(2)]
    trainer = Trainer(model=model, train_dataloader=batches,
                      optimizers=adamw(lr=1e-3, weight_decay=0.01),
                      max_duration="2ba", device="cpu",
                      device_train_microbatch_size=2, seed=3)
    trainer.fit()
    assert trainer.state.timestamp.batch == 2 and trainer.train_state.step == 2
    after = model.unet.state_dict()
    assert all(torch.isfinite(v).all() for v in after.values())
    moved = [k for k in after if not torch.equal(after[k], start[k])]
    assert len(moved) == len(after)


def test_flops_count_the_joint_attention_as_flash_on_the_card_route():
    """On the meta device routed as the card, the bf16 transformer's joint
    attention at head dim 128 (1,024 image + 7 text tokens) is priced by
    the flash formulas, 2 + 3 + 4 units a call, one call a block: the
    SpeedMonitor's MFU counts FLUX at the true joint length."""
    from diffusion_torch.utils.device import route_meta_as
    from diffusion_torch.utils.flops import attention_unit, flops_by_class
    cfg = dict(_TINY, attention_head_dim=128, axes_dims_rope=[16, 56, 56])
    model = flux(cfg, device="meta")
    batch = model.example_batch(2, 512, text_tokens=_TOKENS)
    assert batch["image_latents"].shape == (2, 64, 64, 4)
    with route_meta_as("cuda"):
        counts = flops_by_class(lambda: model.loss_fn(batch).backward())
    joint = 32 * 32 + _TOKENS
    unit = attention_unit((2, joint, 2, 128), (2, joint, 2, 128))
    assert counts["flash"] == 3 * 9 * unit
    assert counts["dot"] > 0
