"""The training step's CUDA graph (`diffusion_torch/train/step_graph.py`).

On the CPU: when the graph may engage (`StepGraph.reason`, one case per
reason and the eligible case), the model's draw helper against
`forward`'s own draws, and a CPU fit, whose every step runs eagerly with
the reason `device`.

On the card (marker `gpu`; each skips, with its reason, without a CUDA
device), a small bf16 UNet whose attention and GroupNorm run the
hand-written kernels: 4 steps with the graph against 4 eager ones from the
same weights and draws, the counts, fresh losses, EMA swaps and the
kernels' launch counters.

    python -m pytest tests/test_torch_step_graph.py -q -p no:randomly
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from diffusion_torch.algorithms.ema import EMA
from diffusion_torch.models.models import stable_diffusion_tiny
from diffusion_torch.models.stable_diffusion import StableDiffusion
from diffusion_torch.models.unet import UNet2DCondition, UNetConfig
from diffusion_torch.ops._build import LaunchCounter
from diffusion_torch.train import step_graph
from diffusion_torch.train.events import Callback
from diffusion_torch.train.optim import adamw
from diffusion_torch.train.trainer import Trainer
from diffusion_torch.utils import profiler

torch.set_num_threads(1)


def _latents(rng, n, side, tokens, width):
    return {"image_latents": rng.standard_normal(
                (n, side, side, 4)).astype(np.float32),
            "caption_latents": rng.standard_normal(
                (n, tokens, width)).astype(np.float32)}


def _tensors(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------- CPU --


def _case(name):
    """(StepGraph, fake trainer, batch) for which `reason` is `name`."""
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True,
                                  remat=name == "remat")
    trainer = types.SimpleNamespace(model=model, _sharded=name == "sharded",
                                    device=torch.device(
                                        "cpu" if name == "device" else "cuda"))
    rng = np.random.default_rng(0)
    batch = _tensors(_latents(rng, 4, 8, 8, 32))
    graph = step_graph.StepGraph()
    graph.warm = name != "warmup"
    if name == "dropout":
        next(m for m in model.unet.modules()
             if hasattr(m, "block_index")).dropout = 0.1
    if name == "raw_batch":
        batch = {"image": torch.zeros(4, 64, 64, 3),
                 "captions": torch.zeros(4, 77, dtype=torch.int64)}
    if name in ("shape", "storage", "captured"):
        # as a capture leaves it
        graph.graph = object()
        graph._batch = step_graph.batch_signature(batch)
        graph._storage = step_graph.storage_signature(model.unet)
    if name == "shape":
        batch = {k: v[:2] for k, v in batch.items()}
    if name == "storage":
        # an EMA swap-in rebinds a parameter's storage
        p = next(model.unet.parameters())
        p.data = p.data.clone()
    return graph, trainer, batch


@pytest.mark.parametrize("name,want", [
    ("device", "device"), ("sharded", "sharded"),
    ("dropout", "dropout"), ("raw_batch", "raw_batch"),
    ("warmup", "warmup"), ("shape", "shape"), ("storage", "storage"),
    ("eligible", None),     # warm, not captured yet: the step captures
    ("captured", None),     # the captured batch and storage: it replays
    ("remat", None),        # a rematerializing UNet captures too
])
def test_reason(name, want):
    graph, trainer, batch = _case(name)
    assert graph.reason(trainer, batch) == want


def test_raw_batch_on_a_model_without_precomputed_latents():
    graph, trainer, batch = _case("eligible")
    trainer.model.precomputed_latents = False
    assert graph.reason(trainer, batch) == "raw_batch"


@pytest.mark.parametrize("n_micro", [1, 2])
def test_training_draws_are_forwards_draws(n_micro):
    """The helper draws what `forward` draws from the same generator, in
    the same order, microbatch after microbatch: bit for bit."""
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    batch = _tensors(_latents(np.random.default_rng(1), 2 * n_micro, 8, 8,
                              32))
    seeded = lambda: torch.Generator().manual_seed(2 ** 40 + 3)
    gen_forward, gen_helper = seeded(), seeded()
    with torch.no_grad():
        for i in range(n_micro):
            mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
            _, target, timesteps = model.forward(mb, gen_forward)
            t, noise = model.training_draws(mb["image_latents"].shape,
                                            gen_helper)
            assert torch.equal(t, timesteps)
            assert torch.equal(noise, target)      # epsilon: the noise
    assert torch.equal(gen_forward.get_state(), gen_helper.get_state())


def test_cpu_steps_run_eagerly():
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    rng = np.random.default_rng(3)
    batches = [_latents(rng, 4, 8, 8, 32) for _ in range(3)]
    counts = profiler.step_graph
    before = (counts.captures, counts.replays, counts.eager["device"])
    profiler.recorder.clear()
    trainer = Trainer(model=model, train_dataloader=batches,
                      max_duration="3ba", device_train_microbatch_size=2,
                      device="cpu")
    trainer.fit()
    assert (counts.captures, counts.replays, counts.eager["device"]) == (
        before[0], before[1], before[2] + 3)
    records = profiler.recorder.steps(0, 3)
    assert len(records) == 3
    for r in records:
        names = [s.name for s in r.spans]
        assert "replay" not in names and "capture" not in names
        assert names.count("backward") == 2


def test_eager_step_takes_the_draws_it_is_given():
    """`_eager_step` with each microbatch's `(noise, timesteps)` given, as
    the graph's capture runs it over its inputs (no noise hook), computes
    the loss and gradients that it computes with the same draws from the
    noise hook: bit for bit."""
    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    rng = np.random.default_rng(5)
    batch = _tensors(_latents(rng, 4, 8, 8, 32))
    draws = [(torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(
                  np.float32)), torch.from_numpy(rng.integers(0, 1000, 2)))
             for _ in range(2)]
    trainer = Trainer(model=model, train_dataloader=[batch],
                      max_duration="1ba", device_train_microbatch_size=2,
                      device="cpu",
                      noise_hook=lambda step, i, n, mb: draws[i])
    params = list(trainer.train_state.params.values())

    def run(**kwargs):
        for p in params:
            p.grad = None
        loss = trainer._eager_step(batch, None, 2, 2, slice(0, 2), 4,
                                   **kwargs)
        return [loss] + [p.grad.clone() for p in params]

    hooked = run()
    trainer.noise_hook = None
    given = run(draws=draws)
    assert all(torch.equal(a, b) for a, b in zip(hooked, given))


# ---------------------------------------------------------------- GPU --


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    # a backward through a plain kernel first: the autograd engine's device
    # thread then holds the CUDA context before a test's backward reaches
    # cuBLAS
    x = torch.ones(1, device="cuda", requires_grad=True)
    (x * 2).sum().backward()
    return torch.device("cuda")


# head size 64, 16x16 latents: the first stage's self-attention (256
# tokens) and cross-attention (128 caption tokens) run the flash kernels,
# every GroupNorm the GroupNorm kernels
_UNET = UNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                   block_has_attention=(True, False),
                   attention_head_dim=(1, 2), cross_attention_dim=64)
_STEPS = 4


def _small_model(device, state=None, remat=False):
    from diffusion_torch.models.layers import init_like_flax_
    with torch.device(device):
        unet = UNet2DCondition(_UNET, dtype=torch.bfloat16, remat=remat)
    if state is None:
        init_like_flax_(unet, torch.Generator(device=device).manual_seed(0))
    else:
        unet.load_state_dict(state)
    unet.train()
    return StableDiffusion(unet=unet, vae=None, text_encoder=None,
                           tokenizer=None, inference_scheduler=None,
                           precomputed_latents=True)


class _Record(Callback):
    """Each step's loss tensor as returned, and how far every launch
    counter grew over the step."""

    def __init__(self, at_end=None):
        self.losses, self.launches = [], []
        self.at_end = at_end
        self._before = None

    def batch_start(self, state, logger):
        self._before = [c.value for c in LaunchCounter.counters()]

    def batch_end(self, state, logger):
        self.losses.append(state.metrics["loss/train/total"])
        self.launches.append([c.value - n for c, n in zip(
            LaunchCounter.counters(), self._before)])
        if self.at_end is not None:
            self.at_end(state)


def _fit(device, state, monkeypatch=None, algorithms=(), at_end=None,
         remat=False, working=True):
    """`_STEPS` steps of 8 latents in 2 microbatches; with `monkeypatch`,
    every step eager; without `working`, the layers cast their weights per
    call (no working-copy scope)."""
    rng = np.random.default_rng(4)
    batches = [_latents(rng, 8, 16, 128, 64) for _ in range(_STEPS)]
    draws = {(s, i): (rng.standard_normal((4, 16, 16, 4)).astype(np.float32),
                      rng.integers(0, 1000, 4))
             for s in range(_STEPS) for i in range(2)}

    def hook(step, micro, n_accum, mb):
        noise, t = draws[(step, micro)]
        return torch.from_numpy(noise), torch.from_numpy(t)

    if monkeypatch is not None:
        monkeypatch.setattr(step_graph.StepGraph, "reason",
                            lambda self, trainer, batch: "warmup")
    model = _small_model(device, state, remat)
    record = _Record(at_end)
    trainer = Trainer(model=model, train_dataloader=batches,
                      optimizers=adamw(lr=1e-4), callbacks=[record],
                      algorithms=list(algorithms),
                      max_duration=f"{_STEPS}ba",
                      device_train_microbatch_size=4, device=device,
                      noise_hook=hook)
    if not working:
        trainer._working_scope = contextlib.nullcontext
    trainer.fit()
    torch.cuda.synchronize()
    if monkeypatch is not None:
        monkeypatch.undo()
    return trainer, record


def _leaf_gap(got, want):
    """The worst leaf's |got - want| over |want| (L2)."""
    return max(float((g.detach().double() - w.detach().double()).norm()
                     / w.detach().double().norm().clamp(min=1e-30))
               for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_graph_steps_match_eager_steps(cuda, monkeypatch, remat):
    state = {k: v.clone() for k, v in
             _small_model(cuda).unet.state_dict().items()}
    counts = profiler.step_graph
    eager, eager_rec = _fit(cuda, state, monkeypatch, remat=remat)
    before = (counts.captures, counts.replays)
    graphed, graphed_rec = _fit(cuda, state, remat=remat)
    assert counts.captures == before[0] + 1
    assert counts.replays >= before[1] + 2
    # the cell's `change` limit is 0.02 at the worst leaf
    for attr in ("params", "optimizer"):
        if attr == "params":
            got = list(graphed.train_state.params.values())
            want = list(eager.train_state.params.values())
            assert _leaf_gap(got, want) <= 1e-3
        else:
            for moment in ("mu", "nu"):
                assert _leaf_gap(getattr(graphed.train_state.optimizer,
                                         moment),
                                 getattr(eager.train_state.optimizer,
                                         moment)) <= 1e-2
    got = torch.stack(graphed_rec.losses).double()
    want = torch.stack(eager_rec.losses).double()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=0)
    # each step's loss is a tensor of its own: the steps' losses differ
    assert len({float(x) for x in graphed_rec.losses}) == _STEPS
    # the capturing and the replayed steps count the launches an eager
    # step counts: the warm-up's, and nothing of the capture's recording
    assert graphed_rec.launches == eager_rec.launches
    assert any(graphed_rec.launches[2])


@pytest.mark.gpu
def test_ema_swaps_and_storage(cuda):
    """A swap-in and swap-out between steps 1 and 2 leaves the graph's
    storage: step 2 replays. A lone swap-in after step 2 moves it: step 3
    runs eagerly for `storage`."""
    holder = []

    def at_end(state):
        ema = holder[0]
        if state.timestamp.batch == 2:
            ema.swap_in(state)
            ema.swap_out(state)
        elif state.timestamp.batch == 3:
            ema.swap_in(state)

    ema = EMA(half_life=None, smoothing=0.9)
    holder.append(ema)
    counts = profiler.step_graph
    before = (counts.captures, counts.replays, counts.eager["storage"])
    profiler.recorder.clear()
    _fit(cuda, None, algorithms=[ema], at_end=at_end)
    assert (counts.captures, counts.replays, counts.eager["storage"]) == (
        before[0] + 1, before[1] + 2, before[2] + 1)
    replayed = [any(s.name == "replay" for s in r.spans)
                for r in profiler.recorder.steps(0, _STEPS)]
    assert replayed == [False, True, True, False]


@pytest.mark.gpu
def test_group_norm_calls_replay_from_one_graph(cuda):
    """GroupNorm calls whose plans differ in cluster size (16 blocks, past
    the portable 8, then fewer) and shared memory, captured in one CUDA
    graph: the graph instantiates, and its replay gives what the eager
    calls gave (the kernels are deterministic)."""
    from diffusion_torch.ops import groupnorm as gn
    shapes = ((8, 4096, 960), (8, 1024, 320))
    assert gn.plan(*shapes[0], 32, 2, True, True).parts > 8
    assert gn.plan(*shapes[1], 32, 2, True, True).parts <= 8
    gen = torch.Generator(device=cuda).manual_seed(5)
    cases = []
    for b, l, c in shapes:
        x, g = (torch.randn((b, l, c), generator=gen, device=cuda).to(
            torch.bfloat16) for _ in range(2))
        scale, bias = (torch.randn(c, generator=gen, device=cuda)
                       for _ in range(2))
        cases.append((x, g, scale, bias))

    def calls():
        out = []
        for x, g, scale, bias in cases:
            y, mean, rstd = gn.group_norm_cuda(x, scale, bias, 32, 1e-5,
                                               "silu")
            out += [y, *gn.group_norm_bwd_cuda(x, scale, bias, mean, rstd,
                                               g, 32, "silu")]
        return out

    want = calls()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        calls()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = calls()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------- the working copies, on the card


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms (its weight-gradient ones may add
    with atomics otherwise), so two runs can agree bit for bit."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def _state_equal(a, b):
    ts_a, ts_b = a.train_state, b.train_state
    pairs = list(zip(ts_a.params.values(), ts_b.params.values()))
    for moment in ("mu", "nu"):
        pairs += zip(getattr(ts_a.optimizer, moment),
                     getattr(ts_b.optimizer, moment))
    return all(torch.equal(x, y) for x, y in pairs)


def _weight_casts(model):
    return sum(p.requires_grad for m in model.unet.modules()
               if getattr(m, "casts_weights", False)
               for p in (m.weight, m.bias) if p is not None)


@pytest.mark.gpu
def test_replayed_steps_equal_per_call_cast_steps(cuda, monkeypatch):
    """The small bf16 UNet: 4 steps replayed with the working copies (the
    copy's pass and the gradients' pass captured in the graph) against 4
    eager steps that cast per call: losses, parameters and moments bit for
    bit; every replayed step adds each trained weight's gradient through
    the op's pass, twice (2 microbatches), and takes no fallback."""
    from diffusion_torch.ops import working_copy as wc
    state = {k: v.clone() for k, v in
             _small_model(cuda).unet.state_dict().items()}
    with _deterministic():
        cast, cast_rec = _fit(cuda, state, monkeypatch, working=False)
        graphed, graphed_rec = _fit(cuda, state)
    assert torch.equal(torch.stack(graphed_rec.losses),
                       torch.stack(cast_rec.losses))
    assert _state_equal(graphed, cast)
    n = _weight_casts(graphed.model)
    for step in graphed_rec.launches:
        assert step[wc.accumulations.index] == 2 * n
        assert step[wc.fallbacks.index] == 0
    assert all(step[wc.refreshes.index] >= 1
               for step in graphed_rec.launches)
    assert all(step[wc.fallbacks.index] == 2 * n
               for step in cast_rec.launches)


@pytest.mark.gpu
def test_replayed_mmdit_steps_equal_per_call_cast_steps(cuda, monkeypatch):
    """A bf16 MMDiT (2 blocks, 32x32 latents and 20 text tokens: joint
    length 276, flash with a ragged tail) 4 steps replayed with the working
    copies against 4 eager steps that cast per call: bit for bit."""
    from diffusion_torch.models.models import stable_diffusion_3
    from diffusion_torch.models.stable_diffusion_3 import POOLED
    cfg = {"sample_size": 32, "patch_size": 2, "in_channels": 16,
           "out_channels": 16, "num_layers": 2, "attention_head_dim": 64,
           "num_attention_heads": 2, "joint_attention_dim": 48,
           "caption_projection_dim": 128, "pooled_projection_dim": 40,
           "pos_embed_max_size": 32}
    rng = np.random.default_rng(6)
    batches = [{"image_latents": rng.standard_normal(
                    (4, 32, 32, 16)).astype(np.float32),
                "caption_latents": rng.standard_normal(
                    (4, 20, 48)).astype(np.float32),
                POOLED: rng.standard_normal((4, 40)).astype(np.float32)}
               for _ in range(_STEPS)]
    draws = {(s, i): (torch.from_numpy(rng.standard_normal(
                          (2, 32, 32, 16)).astype(np.float32)),
                      torch.from_numpy(rng.uniform(0.05, 0.95, 2).astype(
                          np.float32)))
             for s in range(_STEPS) for i in range(2)}
    state = {k: v.clone() for k, v in
             stable_diffusion_3(cfg, device=cuda).unet.state_dict().items()}

    def fit(working):
        if not working:
            monkeypatch.setattr(step_graph.StepGraph, "reason",
                                lambda self, trainer, batch: "warmup")
        model = stable_diffusion_3(cfg, device=cuda)
        model.unet.load_state_dict(state)
        record = _Record()
        trainer = Trainer(model=model, train_dataloader=batches,
                          optimizers=adamw(lr=1e-4), callbacks=[record],
                          max_duration=f"{_STEPS}ba",
                          device_train_microbatch_size=2, device=cuda,
                          noise_hook=lambda s, i, n, mb: draws[(s, i)])
        if not working:
            trainer._working_scope = contextlib.nullcontext
        trainer.fit()
        torch.cuda.synchronize()
        monkeypatch.undo()
        return trainer, record

    counts = profiler.step_graph
    with _deterministic():
        cast, cast_rec = fit(False)
        before = counts.replays
        graphed, graphed_rec = fit(True)
    assert counts.replays == before + _STEPS - 1
    assert torch.equal(torch.stack(graphed_rec.losses),
                       torch.stack(cast_rec.losses))
    assert _state_equal(graphed, cast)


@pytest.mark.gpu
@pytest.mark.parametrize("event", ["ema_swap", "load"])
def test_replay_after_new_weights_reads_them(cuda, monkeypatch, event):
    """New weights between steps, then a replay: the replay's copy pass
    reads them (nothing is cached across steps). `load`: a state_dict
    loaded in place after step 1 (the storage stays; step 2 replays).
    `ema_swap`: the EMA swapped in after step 1 (step 2 runs eagerly on
    its storage) and out after step 2 (step 3 replays; steps count from
    0). Against eager
    per-call-cast steps with the same events: bit for bit."""
    holder = []
    state = {k: v.clone() for k, v in
             _small_model(cuda).unet.state_dict().items()}
    other = {k: v * 0.5 for k, v in state.items()}

    def at_end(st):
        b = st.timestamp.batch
        if event == "load" and b == 2:
            st.model.unet.load_state_dict(other)
        elif event == "ema_swap" and b == 2:
            holder[-1].swap_in(st)
        elif event == "ema_swap" and b == 3:
            holder[-1].swap_out(st)

    def run(**kw):
        holder.append(EMA(half_life=None, smoothing=0.9))
        return _fit(cuda, state, algorithms=[holder[-1]], at_end=at_end,
                    **kw)

    counts = profiler.step_graph
    with _deterministic():
        cast, cast_rec = run(monkeypatch=monkeypatch, working=False)
        profiler.recorder.clear()
        graphed, graphed_rec = run()
    replayed = [any(s.name == "replay" for s in r.spans)
                for r in profiler.recorder.steps(0, _STEPS)]
    assert replayed == ([False, True, False, True] if event == "ema_swap"
                        else [False, True, True, True])
    assert counts.captures >= 1
    assert torch.equal(torch.stack(graphed_rec.losses),
                       torch.stack(cast_rec.losses))
    assert _state_equal(graphed, cast)
