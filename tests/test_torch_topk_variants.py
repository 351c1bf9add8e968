"""The variants study of kernels a, b and c (``examples/topk_variants.py``):
the parts that run without a card. The source rewrite must reach each
named constant of ``csrc/topk_kernels.cu``, and the ptxas reading must give
the score pass's registers and spills for a and b."""

import pytest

from codesearch_tpu_torch.examples import topk_variants as tv
from codesearch_tpu_torch.ops import _build

# ptxas -v lines of both score passes and a select kernel, as nvcc prints
# them for sm_90a
PTXAS = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__e2165350_15_topk_kernels_cu_7c6afdae13cosine_scoresILb1EEEvPKfPKhS2_S4_iiiiPfPii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__e2165350_15_topk_kernels_cu_7c6afdae13cosine_scoresILb1EEEvPKfPKhS2_S4_iiiiPfPii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__e2165350_15_topk_kernels_cu_7c6afdae11select_histINS_7RowKeysELi0EEEvT_iiNS_6SelectE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 16528 bytes smem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__e2165350_15_topk_kernels_cu_7c6afdae13cosine_scoresILb0EEEvPKfPKhS2_S4_iiiiPfPii' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""


def test_score_pass_resources_reads_a_and_b():
    got = tv.score_pass_resources(PTXAS)
    assert {k: v["regs"] for k, v in got.items()} == {"a": 64, "b": 80}
    assert got["a"]["spills"].startswith("8 bytes stack frame")
    assert got["b"]["spills"].startswith("0 bytes stack frame")


@pytest.mark.parametrize("sets", ["kStages=4", "kChunk=384,kStages=4", "kSelItems=16",
                                  "kScoreWarps=8"])
def test_with_constants_sets_each_named_constant(sets):
    src = tv.with_constants((_build.CSRC_DIR / "topk_kernels.cu").read_text(), sets)
    for item in sets.split(","):
        name, value = item.split("=")
        assert f"constexpr int {name} = {value};" in src


def test_with_constants_refuses_an_unknown_name():
    with pytest.raises(RuntimeError, match="kNoSuchConstant"):
        tv.with_constants((_build.CSRC_DIR / "topk_kernels.cu").read_text(), "kNoSuchConstant=1")


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(tv.torch.cuda, "is_available", lambda: False)
    assert tv.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
