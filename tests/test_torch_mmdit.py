"""SD3's MMDiT (`diffusion_torch/models/mmdit.py`) and its rectified-flow
training (`schedulers/flow_match.py`, `models/stable_diffusion_3.py`)
against the plain reference (`portbench/reference/mmdit.py`), on the CPU in
fp32 with seeded weights, at a small size: 2 blocks, the last
`context_pre_only`; width 128 in 2 heads of 64; 16x16 latents (64 image
tokens) and 20 text tokens, so the joint length (84) is ragged. Also the
published config's parameters and state_dict on the meta device, the
position table, the draws' law, the FLOP count and the Trainer.

On the card (marker `gpu`; skips, with its reason, without a CUDA device):
a bf16 MMDiT at a joint length of 1,044 (flash with a ragged tail) trained
4 steps with the step's CUDA graph against 4 eager steps.

    python -m pytest tests/test_torch_mmdit.py -q -p no:randomly
"""

import types

import numpy as np
import pytest
import torch

from diffusion_torch.models.mmdit import SD3_MEDIUM, MMDiT, MMDiTConfig
from diffusion_torch.models.models import stable_diffusion_3
from diffusion_torch.models.stable_diffusion_3 import POOLED
from diffusion_torch.ops import attention as tattn
from diffusion_torch.schedulers import flow_match
from diffusion_torch.train import step_graph
from portbench.reference import mmdit as ref

torch.set_num_threads(1)

_TINY = {"sample_size": 16, "patch_size": 2, "in_channels": 16,
         "out_channels": 16, "num_layers": 2, "attention_head_dim": 64,
         "num_attention_heads": 2, "joint_attention_dim": 48,
         "caption_projection_dim": 128, "pooled_projection_dim": 40,
         "pos_embed_max_size": 24}
_TOKENS = 20


def _pair(seed=0):
    """(program model, reference) in fp32 with the reference's seeded
    weights."""
    torch.manual_seed(seed)
    reference = ref.MMDiT(ref.mmdit_spec(_TINY))
    with torch.no_grad():     # adaLN's modulation away from zero
        for p in reference.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model = stable_diffusion_3(_TINY, encode_latents_in_fp16=False,
                               device="cpu")
    model.unet.load_state_dict(reference.state_dict())
    return model, reference


def _batch(n=3, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return {"image_latents": torch.randn((n, 16, 16, 16), generator=gen),
            "caption_latents": torch.randn((n, _TOKENS, 48), generator=gen),
            POOLED: torch.randn((n, 40), generator=gen)}


def _draws(n=3, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((n, 16, 16, 16), generator=gen),
            flow_match.sample_timesteps(n, gen))


# fp32 on both sides; the program's LayerNorm-modulate and gated residuals
# (addcmul) and its attention (fp32 scores, lse softmax) round in another
# order than the reference's: a few ulps a op over 2 blocks
_TOL = dict(atol=1e-5, rtol=1e-4)


def test_forward_matches_reference():
    model, reference = _pair()
    b = _batch()
    noise, t = _draws()
    x = b["image_latents"].permute(0, 3, 1, 2)
    args = (x, t * 1000, b["caption_latents"], b[POOLED])
    got = model.unet(*args)
    want = reference(*args)
    assert got.dtype == torch.float32 and got.shape == (3, 16, 16, 16)
    torch.testing.assert_close(got, want, **_TOL)


def test_flow_loss_matches_reference():
    model, reference = _pair()
    b = _batch()
    noise, t = _draws()
    got = model.loss_fn(b, None, noise, t)
    want = ref.flow_loss(reference, b, noise, t)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    pred, target, t_out = model.forward(b, None, noise, t)
    torch.testing.assert_close(target, noise - b["image_latents"])
    assert torch.equal(t_out, t)


def test_every_gradient_matches_reference():
    model, reference = _pair()
    b = _batch()
    noise, t = _draws()
    model.loss_fn(b, None, noise, t).backward()
    ref.flow_loss(reference, b, noise, t).backward()
    want = dict(reference.named_parameters())
    got = dict(model.unet.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        w = want[name].grad
        # gradients are sums over the batch and tokens: scale the absolute
        # tolerance to the leaf's size
        torch.testing.assert_close(
            p.grad, w, rtol=1e-4, atol=1e-5 * max(1.0, float(w.abs().max())),
            msg=name)
    # the last block's text queries attend, and what they attend to is
    # dropped: their projection gets a zero gradient, in diffusers as here
    last = got["transformer_blocks.1.attn.add_q_proj.weight"].grad
    assert last is not None and not last.any()


def test_state_dict_at_the_published_config():
    with torch.device("meta"):
        reference = ref.MMDiT(ref.mmdit_spec(dict(
            SD3_MEDIUM.__dict__, _class_name="SD3Transformer2DModel")))
    model = stable_diffusion_3(device="meta")
    got = {k: tuple(v.shape) for k, v in model.unet.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in reference.state_dict().items()}
    assert got == want
    # diffusers' SD3Transformer2DModel names, where the last block differs
    assert got["pos_embed.pos_embed"] == (1, 192 * 192, 1536)
    assert got["pos_embed.proj.weight"] == (1536, 16, 2, 2)
    assert got["context_embedder.weight"] == (1536, 4096)
    assert got["time_text_embed.text_embedder.linear_1.weight"] == (1536,
                                                                     2048)
    assert got["time_text_embed.timestep_embedder.linear_1.weight"] == (
        1536, 256)
    assert got["transformer_blocks.0.norm1_context.linear.weight"] == (
        9216, 1536)
    assert got["transformer_blocks.23.norm1_context.linear.weight"] == (
        3072, 1536)
    assert "transformer_blocks.23.attn.add_q_proj.weight" in got
    assert "transformer_blocks.22.attn.to_add_out.weight" in got
    for gone in ("attn.to_add_out.weight", "ff_context.net.0.proj.weight"):
        assert "transformer_blocks.23." + gone not in got
    assert got["norm_out.linear.weight"] == (3072, 1536)
    assert got["proj_out.weight"] == (64, 1536)


def test_parameter_count():
    model = stable_diffusion_3(device="meta")
    assert sum(p.numel() for p in model.unet.parameters()) == 2_028_328_000
    assert model.unet.config == SD3_MEDIUM


def test_position_table_is_the_centre_crop():
    """The 192 x 192 table at base size 64, cropped to 64 x 64 patches, is
    the sin-cos embedding of positions (64 + i) / 3 on each axis: the
    column in the first half of the channels, the row in the second."""
    with torch.device("meta"):
        net = MMDiT(SD3_MEDIUM)
    table = MMDiT(MMDiTConfig(num_layers=1)).pos_embed.cropped(64, 64)[0]
    assert net.pos_embed.pos_embed.shape == (1, 36864, 1536)
    # diffusers divides float32 positions, then embeds in float64
    pos = ((64 + torch.arange(64, dtype=torch.float32)) / 3.0).double()
    omega = 1.0 / 10000 ** (torch.arange(384, dtype=torch.float64) / 384)

    def axis(p):
        out = p[:, None] * omega[None]
        return torch.cat([out.sin(), out.cos()], dim=1)
    rows, cols = torch.meshgrid(torch.arange(64), torch.arange(64),
                                indexing="ij")
    want = torch.cat([axis(pos)[cols.reshape(-1)],
                      axis(pos)[rows.reshape(-1)]], dim=1)
    torch.testing.assert_close(table.double(), want, atol=1e-6, rtol=0)
    torch.testing.assert_close(
        ref.sincos_table(1536, 192, 64)[None],
        MMDiT(MMDiTConfig(num_layers=1)).pos_embed.pos_embed)


def test_shifted_logit_normal_draws():
    """t = 3 s / (1 + 2 s), s = sigmoid(u), u ~ N(0, 1): in (0, 1), median
    0.75, and a mean that is the law's (quadrature) within 4 standard
    errors."""
    assert flow_match.SHIFT == 3.0
    t = flow_match.sample_timesteps(200_000, torch.Generator().manual_seed(7))
    assert t.dtype == torch.float32
    assert bool(((t > 0) & (t < 1)).all())
    u = np.linspace(-9, 9, 200_001)
    s = 1 / (1 + np.exp(-u))
    dens = np.exp(-u ** 2 / 2) / np.sqrt(2 * np.pi)
    law = 3 * s / (1 + 2 * s)
    mean = np.trapezoid(law * dens, u)
    sd = np.sqrt(np.trapezoid((law - mean) ** 2 * dens, u))
    assert abs(float(t.double().mean()) - mean) < 4 * sd / np.sqrt(t.numel())
    assert abs(float(t.median()) - 0.75) < 0.01
    # the noise sits at t = 1: x_t moves from the data to the noise
    x0, eps = torch.zeros(2, 1, 1, 1), torch.ones(2, 1, 1, 1)
    torch.testing.assert_close(
        flow_match.add_noise(x0, eps, torch.tensor([0.25, 1.0])).flatten(),
        torch.tensor([0.25, 1.0]))


def test_training_draws_are_forwards_draws():
    """`training_draws` gives what `forward` draws from the same
    generator: t first, then the noise."""
    model, _ = _pair()
    b = _batch()
    t, noise = model.training_draws(b["image_latents"].shape,
                                    torch.Generator().manual_seed(3))
    _, target, t_fwd = model.forward(b, torch.Generator().manual_seed(3))
    assert torch.equal(t, t_fwd)
    torch.testing.assert_close(target, noise - b["image_latents"])


def test_flops_count_the_joint_attention_as_flash_on_the_card_route():
    """On the meta device routed as the card, the bf16 MMDiT's joint
    attention (84 tokens would stay on plain math; 1,044 take flash) is
    priced by the flash formulas: 2 + 3 + 4 units a call."""
    from diffusion_torch.utils.device import route_meta_as
    from diffusion_torch.utils.flops import attention_unit, flops_by_class
    cfg = dict(_TINY, sample_size=64, pos_embed_max_size=64)
    model = stable_diffusion_3(cfg, device="meta")
    batch = model.example_batch(2, 512, text_tokens=_TOKENS)
    with route_meta_as("cuda"):
        counts = flops_by_class(lambda: model.loss_fn(batch).backward())
    joint = 32 * 32 + _TOKENS
    unit = attention_unit((2, joint, 2, 64), (2, joint, 2, 64))
    assert counts["flash"] == 2 * 9 * unit
    assert counts["dot"] > 0


def test_reason_and_cpu_fit():
    """`StepGraph.reason` takes the MMDiT model as it takes the UNet's
    (no dropout, precomputed batches): None once warm on a card; on the
    CPU every step runs eagerly (`device`), and trains."""
    from diffusion_torch.train.optim import adamw
    from diffusion_torch.train.trainer import Trainer
    from diffusion_torch.utils import profiler
    model, _ = _pair()
    batch = _batch(4)
    graph = step_graph.StepGraph()
    fake = types.SimpleNamespace(model=model, _sharded=False,
                                 device=torch.device("cuda"))
    assert graph.reason(fake, batch) == "warmup"
    graph.warm = True
    assert graph.reason(fake, batch) is None
    before = profiler.step_graph.eager["device"]
    start = [p.detach().clone() for p in model.unet.parameters()]
    trainer = Trainer(model=model, train_dataloader=[batch] * 3,
                      optimizers=adamw(lr=1e-3), max_duration="3ba",
                      device_train_microbatch_size=2, device="cpu")
    trainer.fit()
    assert profiler.step_graph.eager["device"] == before + 3
    assert trainer.train_state.step == 3
    assert all(torch.isfinite(p).all() for p in model.unet.parameters())
    assert any(not torch.equal(p, s)
               for p, s in zip(model.unet.parameters(), start))


# ---------------------------------------------------------------- GPU --


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    x = torch.ones(1, device="cuda", requires_grad=True)
    (x * 2).sum().backward()
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_steps_match_eager_steps_with_a_ragged_joint_length(
        cuda, monkeypatch):
    """A bf16 MMDiT at 64x64 latents and 20 text tokens (joint length
    1,044: flash with a ragged tail) trained 4 steps from the same
    weights and draws, eagerly and from the step's CUDA graph: one
    capture, replays, the same losses and weights, and the tail counters
    growing by a replay's captured launches."""
    from diffusion_torch.ops import flash_attention as fa
    from diffusion_torch.train.events import Callback
    from diffusion_torch.train.optim import adamw
    from diffusion_torch.train.trainer import Trainer
    from diffusion_torch.utils import profiler
    cfg = dict(_TINY, sample_size=64, pos_embed_max_size=64)
    rng = np.random.default_rng(4)
    batches = [{"image_latents": rng.standard_normal(
                    (4, 64, 64, 16)).astype(np.float32),
                "caption_latents": rng.standard_normal(
                    (4, _TOKENS, 48)).astype(np.float32),
                POOLED: rng.standard_normal((4, 40)).astype(np.float32)}
               for _ in range(4)]
    draws = {(s, i): (torch.from_numpy(rng.standard_normal(
                          (2, 64, 64, 16)).astype(np.float32)),
                      torch.from_numpy(rng.uniform(0.05, 0.95, 2).astype(
                          np.float32)))
             for s in range(4) for i in range(2)}
    state = {k: v.clone() for k, v in
             stable_diffusion_3(cfg, device=cuda).unet.state_dict().items()}

    def fit(eager):
        if eager:
            monkeypatch.setattr(step_graph.StepGraph, "reason",
                                lambda self, trainer, batch: "warmup")
        model = stable_diffusion_3(cfg, device=cuda)
        model.unet.load_state_dict(state)
        losses = []

        class Record(Callback):
            def batch_end(self, st, logger):
                losses.append(float(st.metrics["loss/train/total"]))
        trainer = Trainer(model=model, train_dataloader=batches,
                          optimizers=adamw(lr=1e-4), callbacks=[Record()],
                          max_duration="4ba", device_train_microbatch_size=2,
                          device=cuda,
                          noise_hook=lambda s, i, n, mb: draws[(s, i)])
        trainer.fit()
        torch.cuda.synchronize()
        monkeypatch.undo()
        return trainer, losses

    counts = profiler.step_graph
    eager, eager_losses = fit(True)
    before = (counts.captures, counts.replays, fa.launches_tail.value,
              tattn.flash_calls.value, tattn.plain_calls.value)
    graphed, graphed_losses = fit(False)
    assert counts.captures == before[0] + 1
    assert counts.replays == before[1] + 3
    # 4 steps x 2 microbatches x 2 blocks, each call a tail launch; no
    # plain attention
    assert fa.launches_tail.value - before[2] == 16
    assert tattn.flash_calls.value - before[3] == 16
    assert tattn.plain_calls.value == before[4]
    np.testing.assert_allclose(graphed_losses, eager_losses, rtol=1e-3)
    for g, e in zip(graphed.train_state.params.values(),
                    eager.train_state.params.values()):
        g, e = g.detach().double(), e.detach().double()
        gap = float((g - e).norm() / e.norm().clamp(min=1e-30))
        assert gap <= 1e-3
