"""A training cell at the port's tiny geometry, for runs on the CPU: the
cell's files as the harness reads them, with the tiny model and widths."""

from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import common  # noqa: E402

TINY_UNET = {"in_channels": 4, "out_channels": 4,
             "block_out_channels": [32, 64], "layers_per_block": 1,
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"],
             "attention_head_dim": [2, 4], "cross_attention_dim": 32,
             "norm_num_groups": 8, "norm_eps": 1e-5,
             "use_linear_projection": True, "flip_sin_to_cos": True,
             "freq_shift": 0}


TINY_VAE = {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [8, 8, 8, 8], "layers_per_block": 1,
            "norm_num_groups": 4, "scaling_factor": 0.18215}
TINY_TEXT = {"vocab_size": 514, "hidden_size": 32, "intermediate_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 2,
             "max_position_embeddings": 77, "hidden_act": "gelu",
             "layer_norm_eps": 1e-5}


def tiny_files(cell: str = "sd2-512-train", limits=None) -> dict:
    """The cell's files with the tiny model's widths and a tiny load."""
    files = common.cell_files(common.benchmark(), cell)
    files = copy.deepcopy(files)
    files["config"]["model"] = \
        "diffusion_torch.models.models.stable_diffusion_tiny"
    files["config"].update(unet=dict(TINY_UNET), vae=dict(TINY_VAE),
                           text_encoder=dict(TINY_TEXT))
    if files["traffic"]["kind"] == "train":
        files["traffic"].update(batch_size=4, microbatch=2, latent_side=8,
                                caption_tokens=7, reference_rows=2)
    else:
        files["traffic"].update(size=64, steps=4, rate_per_s=4.0,
                                max_batch_size=4, drain_s=30,
                                check_requests=3, trace_requests=2)
    if limits is not None:
        files["check"]["limits"] = dict(limits)
    return files
