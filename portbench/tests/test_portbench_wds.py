"""The raw-image training cell (`kinds/train_wds.py`) on the CPU at the
port's tiny widths: the shards it writes and the reader over them, a whole
run (correct, and not with a fault planted underneath, a fault in the
reader or the fp8 control), and the cell's four new readers on synthetic
runs."""

import copy
import tarfile
import time

import pytest
import torch

from diffusion_torch.utils import profiler
from portbench import common
from portbench.kinds import train_wds as kind
from portbench.tests.tiny import TINY_TEXT, TINY_UNET, TINY_VAE

CPU = torch.device("cpu")
SEED = 2 ** 33 + 11
# fp32 on both sides at the tiny widths (as test_portbench_reference.py)
LIMITS = {"loss": 1e-5, "first_grad": 1e-3, "change": 1e-2}


@pytest.fixture
def files(tmp_path, monkeypatch):
    monkeypatch.setattr(kind, "_shard_dir",
                        lambda traffic: str(tmp_path / "wds"))
    files = copy.deepcopy(common.cell_files(common.benchmark(),
                                            "sd2-256-train-wds"))
    files["config"]["model"] = \
        "diffusion_torch.models.models.stable_diffusion_tiny"
    files["config"].update(unet=dict(TINY_UNET), vae=dict(TINY_VAE),
                           text_encoder=dict(TINY_TEXT))
    files["config"]["model_kwargs"]["encode_latents_in_fp16"] = False
    files["traffic"].update(batch_size=4, microbatch=2, latent_side=8,
                            reference_rows=2, samples=40, shard_samples=16,
                            image_side=80, resize_size=64)
    files["check"]["limits"] = dict(LIMITS)
    return files


def test_shards_and_reader(files):
    traffic = files["traffic"]
    paths = kind.write_shards(traffic)
    assert len(paths) == 3 and kind.write_shards(traffic) == paths
    with tarfile.open(paths[0]) as tar:
        names = tar.getnames()
    assert names[:2] == ["00000000.jpg", "00000000.txt"] and len(names) == 32
    batches = list(kind.loader(traffic, SEED))
    assert len(batches) == 10       # 40 samples in batches of 4
    b = batches[0]
    assert b["image"].shape == (4, 64, 64, 3) and b["captions"].shape[0] == 4
    assert -1.0 <= b["image"].min() and b["image"].max() <= 1.0
    # the run's seed orders the reader; the data seed alone makes the data
    again = list(kind.loader(traffic, SEED))[0]
    other = list(kind.loader(traffic, SEED + 1))[0]
    assert (again["image"] == b["image"]).all()
    assert not (other["image"] == b["image"]).all()


def _run(files, plant=None):
    return kind.run(files, SEED, 0.3, False, CPU, time.perf_counter(),
                    plant=plant)


def test_sound_run_is_correct(files):
    profiler.recorder.clear()       # other tests' steps in this process
    out = _run(files)
    assert all(c.ok for c in out["checks"]), out["checks"]
    # the reference's own decode of the rows is the program's, pixel for
    # pixel
    assert [c.value for c in out["checks"] if c.name == "pixels"] == [0.0]
    assert out["attempted"] > 0 and out["failed"] == 0
    # the raw-image step stays eager, and its encode is in its own span,
    # in each microbatch's forward (the reader, which leaves out the
    # window's last step, is held to spans below: the window's step count
    # here depends on the CPU's load)
    first = files["traffic"]["checked_steps"]
    records = profiler.recorder.steps(first, first + 1)
    assert [s.name for r in records for s in r.spans].count("encode") == 2


def _unchanged(model, trainer):
    trainer.train_state.optimizer.step = lambda *a, **k: None


def _other_posterior_draws(model, trainer):
    """The encode's eps drawn from another generator: the reference's
    latents are then not the program's."""
    encode = model.encode_images

    def shifted(images, latent_noise=None, generator=None):
        return encode(images, None, torch.Generator().manual_seed(1))

    model.encode_images = shifted


@pytest.mark.parametrize("plant", [_unchanged, _other_posterior_draws],
                         ids=["state unchanged", "other posterior draws"])
def test_a_planted_fault_is_not_correct(files, plant):
    out = _run(files, plant)
    assert not all(c.ok for c in out["checks"]), out["checks"]


class _Reversed:
    """A tokenizer that reads each caption backwards."""

    def __init__(self, tok):
        self.tok = tok

    def __call__(self, text, **kwargs):
        return self.tok(text[::-1], **kwargs)


def _swap_channels(monkeypatch):
    from diffusion_torch.data.transforms import CenterCropSDTransform
    call = CenterCropSDTransform.__call__
    monkeypatch.setattr(CenterCropSDTransform, "__call__",
                        lambda self, img: call(self, img)[..., ::-1])


def _no_centre_crop(monkeypatch):
    from diffusion_torch.data.transforms import CenterCropSDTransform
    init = CenterCropSDTransform.__init__
    monkeypatch.setattr(CenterCropSDTransform, "__init__",
                        lambda self, center_crop=True, size=256:
                        init(self, False, size))


def _reversed_captions(monkeypatch):
    from diffusion_torch.data import wds
    tiny = wds.tiny_tokenizer
    monkeypatch.setattr(wds, "tiny_tokenizer", lambda: _Reversed(tiny()))


@pytest.mark.parametrize("fault", [_swap_channels, _no_centre_crop,
                                   _reversed_captions],
                         ids=["channels swapped", "no centre crop",
                              "captions tokenized backwards"])
def test_a_reader_fault_fails_the_pixels_check(files, monkeypatch, fault):
    """The reference reads the shards itself: a wrong channel order or
    crop in the program's reader, or a tokenizer that gives other ids,
    fails the check on the pixels."""
    fault(monkeypatch)
    out = _run(files)
    pixels = [c for c in out["checks"] if c.name == "pixels"]
    assert len(pixels) == 1 and not pixels[0].ok, out["checks"]


def test_the_fp8_control_fails(files):
    checks = kind.control_numbers(files, SEED, CPU, "fp8")
    assert not all(c.ok for c in checks), checks


def _synthetic(window, config=None):
    files = common.cell_files(common.benchmark(), "sd2-256-train-wds")
    return common.Run(cell=files["cell"],
                      config=config or kind.towers_config(files["config"]),
                      traffic=files["traffic"], window=window)


@pytest.fixture
def rec(monkeypatch):
    rec = profiler.SpanRecorder()
    monkeypatch.setattr(profiler, "recorder", rec)
    return rec


def _steps(rec, n, encode=True):
    """Steps 3.. of the window (and its last), each with a 2 ms `data` and
    two microbatches' 5 ms `encode` inside `forward`, on a hand-set
    clock."""
    clock = iter(range(0, 10 ** 9, 10 ** 6))
    profiler_clock = profiler._clock
    profiler._clock = lambda: next(clock) * 1
    try:
        for i in range(n + 1):
            with rec.span("step", step=3 + i):
                with rec.span("data"):
                    next(clock)
                for m in range(2):
                    with rec.span("forward", micro=m):
                        if encode:
                            with rec.span("encode"):
                                for _ in range(4):
                                    next(clock)
    finally:
        profiler._clock = profiler_clock


def test_data_and_encode_spans(rec):
    _steps(rec, 4)
    run = _synthetic({"steps": 5})
    assert common._reader("data.wait_ms")(run) == pytest.approx(2.0)
    assert common._reader("trainer.encode_host_ms")(run) == pytest.approx(
        10.0)
    assert common._reader("data.wait_ms")(_synthetic({"steps": 0})) is None


def test_encode_is_silent_without_the_span(rec):
    """The parent of the span's change records `data` but no `encode`."""
    _steps(rec, 4, encode=False)
    run = _synthetic({"steps": 5})
    assert common._reader("data.wait_ms")(run) is not None
    assert common._reader("trainer.encode_host_ms")(run) is None


def test_mfu_counts_the_towers():
    from portbench.flops import train_flops
    from portbench.flops_mmdit import wds_train_flops
    config = kind.towers_config(common.cell_files(
        common.benchmark(), "sd2-256-train-wds")["config"])
    unet = train_flops(config["unet"], 16, 32, 77)
    total = wds_train_flops(config, 16, 256, 77)
    # the VAE encoder at 256 px outweighs CLIP; both are forward only
    assert unet < total < 2 * unet
    got = common._reader("mfu.train_wds")(_synthetic(
        {"seconds": 10.0, "samples": 320}, config))
    assert got == pytest.approx(100.0 * total / 16 * 32 / 989e12)
    bare = dict(config)
    del bare["vae"]
    assert common._reader("mfu.train_wds")(_synthetic(
        {"seconds": 10.0, "samples": 320}, bare)) is None


def test_group_norm_roofline_counts_the_encoder():
    """The UNet's GroupNorm calls forward and backward and the VAE
    encoder's forward, at the traced steps' microbatches; silent unless
    the program's call counters over the traced steps are those calls."""
    from portbench.flops import group_norm_bound_s, unet_calls
    from portbench.flops_mmdit import encoder_norms
    from portbench.trace import Trace
    files = common.cell_files(common.benchmark(), "sd2-256-train-wds")
    config, t = kind.towers_config(files["config"]), files["traffic"]
    unet, _ = unet_calls(config["unet"], 16, 32, 77)
    encoder = encoder_norms(config, 16, 256)
    assert (len(unet), len(encoder)) == (61, 22)
    assert encoder[0] == (16, 128, 256, 256)
    passes = 3 * t["batch_size"] // t["microbatch"]
    calls = {"forward": passes * 83, "backward": passes * 61}
    bound = passes * (sum(group_norm_bound_s(s, False)
                          + group_norm_bound_s(s, True) for s in unet)
                      + sum(group_norm_bound_s(s, False) for s in encoder))
    trace = Trace(window_s=2.0, busy_s=1.0, gaps=[], ops=[
        (0.0, 0.25, "gn_fwd_kernel<__nv_bfloat16, 8>"),
        (0.0, 0.25, "gn_bwd_kernel<__nv_bfloat16, 8>")])

    def read(window, config=config, trace=trace):
        return common._reader("group_norm_roofline.train_wds")(common.Run(
            cell=files["cell"], config=config, traffic=t, window=window,
            trace=trace))

    window = {"traced_steps": 3, "group_norm_calls": calls}
    assert read(window) == pytest.approx(100.0 * bound / 0.5)
    assert read(dict(window, group_norm_calls=dict(
        calls, forward=passes * 61))) is None       # the encoder's missing
    assert read(dict(window, group_norm_calls=None)) is None
    assert read(dict(window, traced_steps=0)) is None
    assert read(window, trace=None) is None
