"""`anakin_tpu_torch.tools.kernel_variants` on the CPU: the text edits it
applies to a copy of `csrc/`, and its reading of ptxas's report.  Compiling
and running the variants needs nvcc and a card."""

import pytest

from anakin_tpu_torch.tools import kernel_variants as kv

LOG = """ptxas info    : Compiling entry function '_Z11flash_wgmmaILi128ELi2EEv' for 'sm_90a'
ptxas info    : Function properties for _Z11flash_wgmmaILi128ELi2EEv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
ptxas info    : Compiling entry function '_Z10flash_bf16ILi80ELi2EEv' for 'sm_90a'
ptxas info    : Function properties for _Z10flash_bf16ILi80ELi2EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 216 registers, used 1 barriers
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_Z11flash_wgmmaILi128ELi2EEv'
"""


def test_ptxas_report_reads_the_matching_kernels():
    rows, notes = kv.ptxas_report(LOG, "flash_wgmma")
    assert [name for name, _ in rows] == ["_Z11flash_wgmmaILi128ELi2EEv"]
    assert "8 bytes stack frame" in rows[0][1] and "Used 168 registers" in rows[0][1]
    assert len(notes) == 1 and notes[0].startswith("(C7512) Potential Performance Loss")


@pytest.mark.parametrize("edits, flags", [
    (["static constexpr int BN = 64;=>static constexpr int BN = 32;"], []),
    (["-DNAME", "-Xptxas=-v"], ["-DNAME", "-Xptxas=-v"]),
])
def test_make_variant_applies_edits_and_flags(tmp_path, monkeypatch, edits, flags):
    monkeypatch.setattr(kv, "OUT", str(tmp_path))
    src, got = kv.make_variant("v", edits, "flash_attention", watchdog=True)
    assert got == flags
    text = open(src).read()
    hopper = open(tmp_path / "v" / "hopper.cuh").read()
    assert "asm volatile(\"trap;\")" in hopper  # the mbarrier watchdog
    if not flags:
        assert "static constexpr int BN = 32;" in text
        assert "static constexpr int BN = 64;" not in text


def test_make_variant_refuses_an_edit_that_matches_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(kv, "OUT", str(tmp_path))
    with pytest.raises(ValueError, match="no file holds"):
        kv.make_variant("v", ["no such text=>x"], "flash_attention", watchdog=False)
