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
