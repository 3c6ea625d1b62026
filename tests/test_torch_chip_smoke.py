"""What `chip_smoke.py` reads from nvcc's ptxas log, its refusal to run
without a CUDA device, and its checkpoint phase's disk arithmetic, checked
without a card."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

_NS = "_GLOBAL__N__7e875268_22_flash_attention_bwd_cu_1dfbad47"
_DQ = (f"_ZN{len(_NS)}{_NS}19flash_bwd_dq_kernelE14CUtensorMap_stS0_S0_S0_"
       "S0_PKfPfP13__nv_bfloat16iiiff")
_GN = f"_ZN{len(_NS)}{_NS}13gn_fwd_kernelILi1ELb1EEEvPKT_"
_LOG = f"""ptxas info    : Compiling entry function '{_DQ}' for 'sm_90a'
ptxas info    : Function properties for {_DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 928 bytes cmem[0]
ptxas info    : Compiling entry function '{_GN}' for 'sm_90a'
ptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to non wgmma instructions defining input \
registers of a wgmma between start and end of the pipeline stage in the \
function '{_DQ}'
ptxas info    : Function properties for {_GN}
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, 21504 bytes smem, 400 bytes cmem[0]
"""


@pytest.mark.parametrize("mangled,name", [
    (_DQ, "flash_bwd_dq_kernel"),
    (_GN, "gn_fwd_kernelILi1ELb1EE"),      # template arguments stay mangled
])
def test_kernel_name(mangled, name):
    assert chip_smoke._kernel_name(mangled) == name


def test_ptxas_usage_per_kernel():
    """Each figure goes to the kernel whose section it is in; a note that
    ptxas serialized the wgmma instructions goes to the kernel it names."""
    usage = chip_smoke._ptxas_usage(_LOG)
    assert usage == {
        "flash_bwd_dq_kernel": {"spill_stores": 0, "spill_loads": 0,
                                "registers": 168, "static_smem": 0,
                                "wgmma_serialized": ["C7513"]},
        "gn_fwd_kernelILi1ELb1EE": {"spill_stores": 4, "spill_loads": 8,
                                    "registers": 64, "static_smem": 21504}}


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_checkpoint_phase_disk_need():
    """Phase 10's peak: two fp32 checkpoints of the 865.9M-parameter UNet
    (params, mu, nu: 10.39 GB each) and the fp16 pretrained directory
    (UNet, the whole VAE with its 34.2M-parameter encoder, CLIP text:
    2.58 GB), plus the shards."""
    sizes = chip_smoke._sd2_sizes()
    assert sizes == (865_910_724, 49_490_199 + 34_163_664, 340_387_840)
    disk = chip_smoke._checkpoint_disk_need(*sizes, shard_bytes=0)
    assert disk["checkpoint"] == 12 * 865_910_724
    assert disk["pretrained"] == 2 * sum(sizes)
    assert disk["need"] == 2 * disk["checkpoint"] + disk["pretrained"]
    assert 23.2e9 < disk["need"] < 23.4e9


def test_checkpoint_phase_refuses_short_disk(monkeypatch, tmp_path):
    class Usage:
        free = 20 * 10 ** 9

    monkeypatch.setattr(chip_smoke.shutil, "disk_usage", lambda p: Usage)
    need = chip_smoke._checkpoint_disk_need(*chip_smoke._sd2_sizes())["need"]
    with pytest.raises(RuntimeError, match=r"needs 23\.\d GB free .* 20\.0 "
                                           r"GB are free"):
        chip_smoke._check_disk(str(tmp_path), need)
    Usage.free = need
    assert chip_smoke._check_disk(str(tmp_path), need) == need


def test_online_phase_shards_compose_with_the_wds_yaml(tmp_path):
    """Phase 8b's tar shards, manifest and filter strategy: the unedited
    yamls/SD-2-base-256-wds.yaml composes with its overrides into the
    port's wds reader, whose batches are (32, 256, 256, 3) images in
    [-1, 1] and token ids; the filter keeps every sample but the flagged
    eighth."""
    from diffusion_torch.config import instantiate, load_config
    from diffusion_torch.data.datapipes import (filter_samples, list_shards,
                                                tar_samples)
    from diffusion_torch.data.filters import load_filter_strategy

    overrides, manifest, strategy, flagged = chip_smoke._online_overrides(
        str(tmp_path), str(tmp_path / "metrics.jsonl"), "no card")
    config = load_config(os.path.join(chip_smoke._ROOT, "yamls",
                                      "SD-2-base-256-wds.yaml"), overrides)
    assert config["model"]["precomputed_latents"] is False
    assert config["trainer"]["device_train_microbatch_size"] == 16
    assert config["dataset"]["eval_batch_size"] == 32
    shards = list_shards([], manifest=manifest)
    assert len(shards) == 4
    keys = [s["__key__"] for s in tar_samples(shards)]
    assert len(keys) == chip_smoke.ONLINE_TRAIN
    assert len(flagged) == chip_smoke.ONLINE_TRAIN // 8
    kept = [s["__key__"] for s in filter_samples(
        tar_samples(shards), load_filter_strategy(strategy))]
    assert sorted(kept) == sorted(set(keys) - flagged)
    loader = instantiate(config["dataset"]["train_dataset"], batch_size=32)
    assert type(loader).__module__ == "diffusion_torch.data.datapipes"
    batch = next(iter(loader))
    assert batch["image"].shape == (32, 256, 256, 3)
    assert -1.0 <= batch["image"].min() and batch["image"].max() <= 1.0
    assert batch["captions"].shape == (32, 77)


def test_composed_phase_evaluates_on_coco_shards(tmp_path):
    """Phase 8's eval set is the recipe's COCO reader over COCO MDS shards
    (JPEGs of COCO's sizes, five captions each), with the frozen towers
    built; phase 10 keeps the LAION eval over precomputed latents."""
    from diffusion_torch.config import instantiate, load_config

    yaml = os.path.join(chip_smoke._ROOT, "yamls", "SD-2-base-256.yaml")
    coco = load_config(yaml, chip_smoke._composed_overrides(
        str(tmp_path / "a"), "composed", "m.jsonl", coco_eval=True))
    assert coco["model"]["init_frozen_towers"] is True
    node = coco["dataset"]["eval_dataset"]
    assert node["_target_"].endswith("coco.build_streaming_cocoval_dataloader")
    loader = instantiate(node, batch_size=32)
    batch = next(iter(loader))
    assert batch["image"].shape == (32, 256, 256, 3)
    assert 0.0 <= batch["image"].min() and batch["image"].max() <= 1.0
    laion = load_config(yaml, chip_smoke._composed_overrides(
        str(tmp_path / "b"), "checkpoint", "m.jsonl"))
    assert "init_frozen_towers" not in laion["model"]
    assert laion["dataset"]["eval_dataset"]["_target_"].endswith(
        "laion.build_streaming_laion_dataloader")


def test_inpainting_mask_and_images():
    import numpy as np
    mask = chip_smoke._left_half_mask(8, 6)
    assert mask.dtype == np.uint8 and mask.shape == (8, 6)
    assert (mask[:, :3] == 255).all() and (mask[:, 3:] == 0).all()
    img = chip_smoke._smooth_image(np.random.default_rng(0), 24, 40)
    assert img.shape == (24, 40, 3) and img.dtype == np.uint8
    assert img.std() > 10


@pytest.mark.parametrize("got,steps_run,encoder,ok", [
    ({"group_norm": 1250, "flash_attention": 200}, 20, 0, True),
    ({"group_norm": 1251, "flash_attention": 200}, 20, 0, False),
    ({"group_norm": 1250, "flash_attention": 190}, 20, 0, False),
    # img2img at strength 0.5: 10 UNet steps run, plus the encoder's 22
    ({"group_norm": 1250 - 610 + 22, "flash_attention": 100}, 10, 22, True),
    ({"group_norm": 1250 - 610, "flash_attention": 100}, 10, 22, False),
])
def test_sampler_phase_launch_equality(got, steps_run, encoder, ok):
    """Phase 5c holds each sampler request's forward launches to phase
    5b's 20-step DDIM text request's (61 GroupNorm calls and 10 flash
    calls a UNet step at 512px): equal for text requests, less the steps
    not run plus the encoder's GroupNorm calls for img2img."""
    text = {"group_norm": 1250, "flash_attention": 200}
    assert chip_smoke._launches_match(got, text, steps_run, 61,
                                      encoder) is ok


def test_sampler_phase_requests():
    """Four 20-step requests: dpm++2m, euler, DDIM with rescale 0.7, and a
    dpm++2m img2img at strength 0.5, each a valid request of the port's
    endpoint (its batch keys differ, so none merge)."""
    import numpy as np

    from diffusion_torch.inference.inference_model import \
        StableDiffusionInference
    from diffusion_torch.models.models import stable_diffusion_tiny

    endpoint = StableDiffusionInference(builder=stable_diffusion_tiny,
                                        device="cpu", default_size=32)
    names = [k for k, _ in chip_smoke.SAMPLER_REQUESTS]
    assert names == ["dpm++2m", "euler", "ddim rescaled", "dpm++2m img2img"]
    image = chip_smoke._b64_png(chip_smoke._smooth_image(
        np.random.default_rng(0), 32, 32))
    keys = set()
    for _, extra in chip_smoke.SAMPLER_REQUESTS:
        req = dict(prompt="x", num_inference_steps=chip_smoke.STEPS,
                   **extra)
        if "strength" in extra:
            req["image"] = image
        keys.add(endpoint.batch_key(req))
    assert len(keys) == 4


def test_eval_job_arguments(tmp_path):
    """Phase 11's two argument lists parse with the port's scripts: the
    eval job at 256px, 2 batches of 16, guidance 3.0, dpm++2m at 20 steps,
    random towers, on the card, writing --out; coco_eval at 1.0 and 7.0
    with 10 DDIM steps."""
    from diffusion_torch.scripts import coco_eval, fid_clip_evaluation

    fid_args, coco_args = chip_smoke._eval_job_args(
        str(tmp_path / "coco"), str(tmp_path / "out.jsonl"))
    a = fid_clip_evaluation.parse_args(fid_args)
    assert (a.size, a.batch_size, a.subset_num_batches) == (256, 16, 2)
    assert (a.guidance_scale, a.scheduler, a.num_inference_steps) == (
        3.0, "dpm++2m", 20)
    assert a.allow_random_towers and a.device == "cuda:0"
    assert a.out == str(tmp_path / "out.jsonl")
    assert a.builder == "diffusion_torch.models.models.stable_diffusion_2"
    c = coco_eval.parse_args(coco_args)
    assert c.guidance_scales == [1.0, 7.0] and c.num_inference_steps == 10
    assert (c.subset_num_batches, c.batch_size, c.device) == (1, 16, "cuda:0")
    assert chip_smoke.EVAL_SAMPLES >= chip_smoke.EVAL_BATCH * \
        chip_smoke.EVAL_BATCHES


_TINY = ["model._target_=diffusion_tpu.models.models.stable_diffusion_tiny",
         "+model.device=cpu", "+trainer.device=cpu"]


def _tiny_train(yaml, overrides):
    """Compose a phase's overrides with the tiny model on the CPU (a
    rehearsal of the phase without the card) and return the Trainer."""
    from diffusion_torch.config import load_config
    from diffusion_torch.train.train import build_trainer
    config = load_config(os.path.join(chip_smoke._ROOT, "yamls", yaml),
                         overrides + _TINY)
    return config, build_trainer(config)


def test_lora_phase_composes_and_records(tmp_path):
    """Phase 12's data and overrides: the unedited
    yamls/SD-2-base-256-lora.yaml composes (rank 8, adapters only, the
    pretrained directory, raw JPEG + caption MDS shards, the COCO eval, a
    save every 3 batches); at the tiny geometry on the CPU (random base) 2
    batches of 4 train only the adapters and LoraRecord sees the base
    bit-unchanged and the adapters changed."""
    import numpy as np

    from diffusion_torch.models.lora import is_lora_key
    rng = np.random.default_rng(0)
    raw, coco = str(tmp_path / "raw"), str(tmp_path / "coco")
    assert chip_smoke._write_raw_shards(raw, 16, rng) > 0
    chip_smoke._write_coco_shards(coco, 8, rng)
    overrides = chip_smoke._lora_overrides(
        str(tmp_path / "pre"), raw, coco, str(tmp_path / "ckpt"),
        str(tmp_path / "m.jsonl"))
    from diffusion_torch.config import load_config
    full = load_config(os.path.join(chip_smoke._ROOT, "yamls",
                                    "SD-2-base-256-lora.yaml"), overrides)
    assert full["model"]["lora_rank"] == 8 and full["model"]["pretrained"]
    assert full["trainer"]["save_interval"] == "3ba"
    assert full["batch_size"] == 32
    config, tr = _tiny_train("SD-2-base-256-lora.yaml", overrides + [
        "model.pretrained=false", "batch_size=4",
        "trainer.device_train_microbatch_size=2",
        "trainer.max_duration=2ba", "dataset.train_dataset.num_workers=0",
        "dataset.train_dataset.resize_size=32", "trainer.image_size=32"])
    assert tr.model.train_lora_only
    assert all(is_lora_key(n) for n in tr.train_state.params)
    record = next(c for c in tr.engine.callbacks
                  if isinstance(c, chip_smoke.LoraRecord))
    try:
        tr.fit()
    finally:
        tr.close()
    assert record.trainable == sum(p.numel() for p in
                                   tr.train_state.params.values())
    assert record.base_unchanged and record.adapters_changed > 0
    assert record.first_batch["image"].shape == (4, 32, 32, 3)
    assert len(record.steps) == 2
    assert os.path.isdir(tmp_path / "ckpt" / "ba2")


def test_reader_phase_composes_and_counts_sources(tmp_path):
    """Phase 13's data and overrides: the Pexels manifest (a record that
    names a missing file among them) and three tar-shard sources compose
    with the unedited pexels and mixdata yamls; log_traces adds the default
    profiler beside the phase's own; ReaderRecord counts the samples each
    mixture source yields (a tiny CPU run of 1 batch)."""
    import numpy as np

    from diffusion_torch.utils.profiler import TorchProfiler
    rng = np.random.default_rng(1)
    manifest, nbytes = chip_smoke._write_pexels_manifest(
        str(tmp_path / "pexels"), 40, rng)
    with open(manifest) as f:
        records = __import__("json").load(f)["samples"]
    missing = [r for r in records if len(r["local_paths"]) == 2]
    assert len(missing) == 2 and not os.path.exists(
        missing[0]["local_paths"][1])
    _, tr = _tiny_train("SD-2-base-256-pexels.yaml",
                        chip_smoke._pexels_overrides(
                            manifest, str(tmp_path / "traces")))
    profs = sorted((p.start_batch, p.num_batches) for p in
                   tr.engine.callbacks if isinstance(p, TorchProfiler))
    assert profs == [(1, 2), (10, 3)]
    assert type(tr.train_dataloader).__module__ == \
        "diffusion_torch.data.pexels"
    assert tr.micro_size == 16 and tr.max_batches == chip_smoke.READER_STEPS
    tr.close()
    sources = {}
    for k, name in enumerate(("laion", "coyo", "cc")):
        m, _, _ = chip_smoke._write_wds_shards(
            str(tmp_path / name), 8, rng, start=10000 * (k + 1))
        sources[name] = os.path.dirname(m)
    chip_smoke._write_coco_shards(str(tmp_path / "coco"), 4, rng)
    _, tr = _tiny_train("SD-2-base-256-mixdata.yaml", chip_smoke._mix_overrides(
        manifest, sources, str(tmp_path / "coco")) + [
            "batch_size=4", "trainer.device_train_microbatch_size=2",
            "trainer.max_duration=1ba", "~algorithms",
            "dataset.train_dataset.resize_size=32", "trainer.image_size=32"])
    loader = tr.train_dataloader
    assert type(loader).__module__ == "diffusion_torch.data.mix"
    assert [c.name for c in loader.pipes_to_weights] == [
        "pexels", "laion", "coyo", "cc"]
    record = next(c for c in tr.engine.callbacks
                  if isinstance(c, chip_smoke.ReaderRecord))
    record.loader = loader
    try:
        tr.fit()
    finally:
        tr.close()
    assert sorted(record.drawn) == ["cc", "coyo", "laion", "pexels"]
    assert sum(record.drawn.values()) >= 4 and record.drawn["laion"] > 0


def test_pixel_phase_constants():
    """Phase 14 trains at 64x64 pixels, batch 16 in microbatches of 8: its
    top UNet stage attends over 4096 tokens, a flash shape (the 512px
    serving shape)."""
    from diffusion_torch.ops.attention import flash_eligible
    s = chip_smoke.PIXEL_SIZE ** 2
    assert s == 4096 and chip_smoke.PIXEL_BATCH % chip_smoke.PIXEL_MICRO == 0
    assert flash_eligible("cuda", torch.bfloat16, (8, s, 5, 64),
                          (8, s, 5, 64), False)
    assert not flash_eligible("cuda", torch.bfloat16, (8, s, 5, 64),
                              (8, 77, 5, 64), False)


def test_recipe_phase_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """Phase 15 at the tiny geometry on the CPU: the sources it writes, the
    precompute job over them with phase 15's arguments (the tiny towers
    saved as a diffusers directory), convert_coco, then the unedited
    256 and 512 yamls with phase 15's overrides (cut to batches of 4):
    phase 1 saves ba3, phase 2 warm-starts from it, and RecipeRecord sees
    the saved weights, a fresh optimizer and clock, and the EMA copying the
    weights."""
    import numpy as np

    from diffusion_torch.models import models as tmodels
    from diffusion_torch.scripts import convert_coco, precompute_latents
    from diffusion_torch.train.train import train
    from diffusion_torch.utils import safetensors

    # the records synchronise the card around an eval; here there is none
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "RECIPE_RAW", 12)
    monkeypatch.setattr(chip_smoke, "RECIPE_COCO", 8)
    monkeypatch.setattr(tmodels, "stable_diffusion_2",
                        tmodels.stable_diffusion_tiny)
    tmp = str(tmp_path)
    src = chip_smoke._write_recipe_sources(tmp, np.random.default_rng(0))
    pre = tmp_path / "pre"
    towers = tmodels.stable_diffusion_tiny(device="cpu",
                                           init_frozen_towers=True, seed=3)
    for name, fname in (("vae", "diffusion_pytorch_model.safetensors"),
                        ("text_encoder", "model.safetensors")):
        os.makedirs(pre / name)
        safetensors.save_file(getattr(towers, name).state_dict(),
                              str(pre / name / fname))
    args = chip_smoke._precompute_args(src, tmp, str(pre))
    assert args[args.index("--sizes") + 1:][:2] == ["256", "512"]
    job = precompute_latents.main(args + ["--device", "cpu"])
    assert job["samples"] == 12 and job["towers"] == "loaded"
    assert not [f for f in os.listdir(tmp_path / "cache")
                if f.endswith(".mds")]
    coco = str(tmp_path / "coco")
    assert convert_coco.main(["--annotations", src["annotations"],
                              "--image-dir", src["images"], "--out", coco,
                              "--num-samples", "8"]) == 8
    cut = _TINY + ["batch_size=4", "trainer.device_train_microbatch_size=2",
                   "dataset.train_dataset.num_workers=0",
                   "+dataset.train_dataset.caption_latent_dim=32"]
    from diffusion_torch.config import load_config
    ckpt_dir = str(tmp_path / "ckpt")
    configs = {}
    for phase, yaml in ((1, "SD-2-base-256.yaml"), (2, "SD-2-base-512.yaml")):
        overrides = chip_smoke._recipe_overrides(
            phase, job["out"], ckpt_dir, coco, str(tmp_path / f"{phase}.jsonl"))
        full = load_config(os.path.join(chip_smoke._ROOT, "yamls", yaml),
                           overrides)
        configs[phase] = full
        extra = [] if phase == 1 else ["dataset.eval_dataset.num_workers=0"]
        tr = train(load_config(os.path.join(chip_smoke._ROOT, "yamls", yaml),
                               overrides + cut + extra))
        record = next(c for c in tr.engine.callbacks
                      if isinstance(c, chip_smoke.ComposedRecord))
        assert all(np.isfinite(v) for m, *_ in record.steps
                   for v in m.values())
        if phase == 1:
            assert len(record.steps) == 3
            assert os.path.exists(os.path.join(ckpt_dir, "ba3", "meta.json"))
    assert configs[1]["batch_size"] == 32 and "eval_dataset" not in \
        configs[1]["dataset"]
    assert configs[2]["batch_size"] == 16
    assert configs[2]["trainer"]["device_train_microbatch_size"] == 8
    assert configs[2]["trainer"]["load_weights_only"] is True
    assert configs[2]["model"]["init_frozen_towers"] is True
    assert configs[2]["dataset"]["eval_batch_size"] == 8
    assert isinstance(record, chip_smoke.RecipeRecord)
    assert record.warm == {"params_equal_saved": True, "count": 0,
                           "moments_zero": True, "batch": 0, "step": 0,
                           "ema_equal_params": True}
    assert len(record.steps) == 4 and record.ema_tracks == [True] * 4
    assert len(record.evals) == 1 and record.evals[0][0] == 2
    assert tr.train_dataloader.dataset.image_size == 512
