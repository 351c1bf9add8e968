"""The warp-count study of kernels d, e and f (``examples/attention_variants.py``):
the parts that run without a card. The source rewrite must reach every warp
constant of ``csrc/attention_kernels.cu``, and the ptxas reading must give
the registers, spills and CTAs per SM of each two-sweep and flash kernel."""

import pytest

from codesearch_tpu_torch.examples import attention_variants as av
from codesearch_tpu_torch.ops import _build

# ptxas -v lines of two two-sweep kernels and one other kernel (a flash
# kernel of an older signature, one template argument), as nvcc prints them
# for sm_90a
PTXAS = """\
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__50103509_20_attention_kernels_cu_31c239c519attention_two_sweepILi32ELi4ELi8ELb1EEEvPK13__nv_bfloat16S3_S3_PKfPS1_NS_6LayoutEiiif' for 'sm_90a'
    40 bytes stack frame, 40 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 40 bytes cumulative stack size, 128 bytes smem
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__50103509_20_attention_kernels_cu_31c239c515attention_flashILi32EEEvPK13__nv_bfloat16S3_S3_PKfPS1_NS_6LayoutEiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 91 registers, used 1 barriers, 9984 bytes smem
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__50103509_20_attention_kernels_cu_31c239c519attention_two_sweepILi32ELi1ELi4ELb0EEEvPK13__nv_bfloat16S3_S3_PKfPS1_NS_6LayoutEiiif' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size, 16 bytes smem
"""


def test_resources_reads_each_two_sweep_kernel():
    rows = av.resources(PTXAS)
    assert [(r["kernel"], r["dh"], r["P"], r["W"], r["regs"]) for r in rows] == [
        ("f", 32, 4, 8, 64), ("d", 32, 1, 4, 80)]
    assert rows[0]["spills"].startswith("40 bytes stack frame")
    # f: 64 registers x 1,024 threads fill the SM's 65,536; d: 80 x 128 allow 6
    assert [(r["ctas_per_sm"], r["warps_per_sm"]) for r in rows] == [(1, 32), (6, 24)]


@pytest.mark.parametrize("warps", av.WARPS)
def test_with_warps_sets_every_warp_constant(warps):
    src = av.with_warps((_build.CSRC_DIR / "attention_kernels.cu").read_text(), warps)
    for name in ("kFullWarps", "kPackedWarpsP2", "kPackedWarpsP4", "kFlashWarps"):
        assert f"constexpr int {name} = {warps};" in src
    with pytest.raises(RuntimeError, match="kFullWarps"):
        av.with_warps("constexpr int kPackedWarpsP2 = 4;", warps)


FLASH_PTXAS = """\
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__50103509_20_attention_kernels_cu_31c239c515attention_flashILi64ELi8EEEvPK13__nv_bfloat16S3_S3_PKfPS1_NS_6LayoutEiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 37888 bytes smem
"""


def test_resources_reads_each_flash_kernel():
    rows = av.resources(FLASH_PTXAS)
    assert [(r["kernel"], r["dh"], r["P"], r["W"], r["regs"]) for r in rows] == [
        ("e", 64, 1, 8, 128)]
    # 128 registers x 256 threads: 2 CTAs (16 warps) an SM
    assert (rows[0]["ctas_per_sm"], rows[0]["warps_per_sm"]) == (2, 16)


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(av.torch.cuda, "is_available", lambda: False)
    assert av.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
