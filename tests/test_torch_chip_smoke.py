"""What `chip_smoke.py` reads from nvcc's ptxas log, and its refusal to run
without a CUDA device, checked without one."""

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
